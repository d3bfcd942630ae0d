// Flash attention at head dims above 256: the wide-head route.
//
// Replaces, at any head dim D, the Pallas kernels of
// horovod_tpu/ops/attention.py: _flash_fwd_kernel (:138, forward: O and
// lse), _flash_dq_kernel (:198, dQ) and _flash_dkv_kernel (:252, dK and
// dV). The kernels of flash_attention.cu keep every output row of a tile in
// registers across the whole of D, which stops at D = 256. Here the shared
// memory a block holds does not grow with D.
//
// bf16 and float16 forward, dQ and dK/dV (flash_fwd_wide_kernel,
// flash_dq_wide_kernel, flash_dkv_wide_kernel): Hopper kernels on the
// pattern of flash_attention.cu (flash_hopper.cuh, sm90.cuh). What bounds
// them, against the H100 SXM data-sheet peaks at its 700 W limit (989
// TFLOP/s bf16, 3.35 TB/s): at B*H = 32, S = 512, D = 512 the forward needs
// 17.18 GFLOP over 67.2 MB (0.0174 ms of operations, 0.0201 ms of bytes: at
// the ridge point), dQ 25.77 GFLOP over 84.1 MB and dK/dV 34.36 GFLOP over
// 100.9 MB (both bound by operations). Either way the products must run on
// the tensor cores, which only wgmma reaches at rate, and the scores must
// never reach device memory. So:
//   - Persistent blocks, one per SM, walk the work tiles; a block is two
//     consumer warpgroups and a producer warp that keeps TMA loads in flight
//     and gives its registers to the consumers (setmaxnreg).
//   - Nothing stays resident: every operand streams through one ring of
//     32 KB stages (full/empty mbarriers) as boxes of 64 rows by 64 columns
//     (128-byte rows, the 128 B swizzle), from 3-D tensor maps (D, S, BH):
//     rows past S and columns past D read as zeros, so D needs to be a
//     multiple of 8 only (16-byte rows), and the ring's size is the same at
//     every D.
//   - Forward, work tile (bh, 64 Q rows, 512 output columns): both consumer
//     warpgroups compute the same S = Q K^T (SS wgmma over the whole of D,
//     64 columns per stage) and the same online softmax; warpgroup w holds
//     O for its own 256 columns in 128 fp32 registers (O += P V, RS wgmma,
//     one 64-key x 256-column V stage each). One pass over the keys for
//     D <= 512, ceil(D / 512) passes above; each pass repeats its own online
//     softmax. The duplicated S costs 1.5x the needed operations at D = 512
//     (2.5x at D = 1024), on the tensor cores, in exchange for no exchange of
//     scores between the warpgroups.
//   - dQ, work tile (bh, 64 Q rows, 512 output columns), looping over the
//     key tiles the rows can see: warpgroup 0 computes S = Q K^T and P,
//     warpgroup 1 dP = dO V^T (SS, over the whole of D, a stage per 64
//     columns of Q, K, dO and V). P goes to warpgroup 1 in fp32 through
//     shared memory (named barriers), which forms dS = P (dP - delta +
//     g_lse), rounds it to T and writes it to shared memory in the format
//     of a K-major box; then each warpgroup adds dS K of its 256 columns to
//     dQ in 128 fp32 registers (SS: dS K-major, K MN-major, 64 keys x 256
//     columns a stage). At D <= 512 that is exactly the three needed
//     products (ceil(D / 512) passes above, each with its own S and dP).
//   - dK/dV, work tile (bh, 64 keys, 256 output columns): warpgroup 0
//     computes S^T = K Q^T and P^T, and holds dV of the columns; warpgroup 1
//     computes dP^T = V dO^T and holds dK. Per Q tile of 64 rows, P^T goes
//     from warpgroup 0 to 1 in fp32 through shared memory (two buffers,
//     named barriers), warpgroup 1 forms dS^T = P^T (dP^T - delta + g_lse),
//     then dV += P^T dO and dK += dS^T Q (RS wgmma, dO and Q MN-major,
//     64 rows x 256 columns a stage). ceil(D / 256) passes, each computing
//     S^T and dP^T once (split between the warpgroups): 1.5x the needed
//     operations at D = 512 (2.5x at D = 1024).
//   - Outputs leave straight from registers, 16 bytes a thread (store_rows),
//     columns past D not written.
// P and dS are rounded to the operand dtype before their products, as the
// TPU kernels do.
//
// The float32 forward, dQ and dK/dV run on the tensor cores in 3xTF32
// (flash_attention_3xtf32.cu: flash_fwd_wide_3xtf32_kernel,
// flash_dq_wide_3xtf32_kernel and flash_dkv_wide_3xtf32_kernel, through
// launch_fwd_wide_3xtf32, launch_dq_wide_3xtf32 and launch_dkv_wide_3xtf32),
// which hold float32's tolerance (one TF32 product would not hold 1e-4).
//
// Every kernel: D zero-padded by the wrapper to a multiple of 32 with the
// scale of the true D (attention.py:padded_heads); any B*H, ragged Sq and
// Sk, causal masking on global positions q_offset + i >= k_offset + j,
// LSE_MASKED for rows that see no key, and the lse cotangent g_lse as the
// other routes.

#include "flash_hopper.cuh"

// float32 forward, dQ and dK/dV on the tensor cores
// (flash_attention_3xtf32.cu): any D above 256 that is a multiple of 32
// (any other D, or a dK/dV scratch smaller than wide_dkv_scratch_bytes:
// cudaErrorInvalidValue).
long long wide_dkv_scratch_bytes(int BH, int Sq, int Sk);
int launch_fwd_wide_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                           cudaStream_t stream);
int launch_dq_wide_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* glse, void* dq, int BH,
                          int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                          cudaStream_t stream);
int launch_dkv_wide_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* glse, void* dk,
                           void* dv, void* scratch, long long scratch_bytes, int BH, int Sq,
                           int Sk, int D, float scale, int causal, int qo, int ko,
                           cudaStream_t stream);

namespace {

// ===========================================================================
// bf16 and float16 on Hopper: the forward, dQ and dK/dV, warp-specialized
// wgmma kernels fed by TMA through one ring of stages.
// ===========================================================================

constexpr int H_ROWS = 64;                       // rows of a work tile and of a streamed tile
constexpr int H_BOX = 64;                        // columns of a TMA box (128-byte rows)
constexpr int H_BOX_BYTES = H_ROWS * H_BOX * 2;  // 8 KB
constexpr int H_STAGE = 4 * H_BOX_BYTES;         // 32 KB: one ring stage
constexpr int H_OUT = 256;  // output columns of a consumer (128 fp32 registers a thread)

// Shared memory, byte offsets from a 1024-aligned base. Forward: the ring
// of FWD_H_STAGES stages, then its full/empty barriers. A stage holds one
// of a key tile's items, in order: ceil(D / 64) S items (64 Q rows, then
// 64 K rows, by 64 columns: a box each) and one V item per consumer
// warpgroup (64 keys by its 256 output columns: four boxes). At D = 512 a
// key tile is ten items, at D = 1024 eighteen; the ring is the same at
// every D.
constexpr int FWD_H_STAGES = 7;
constexpr int FWD_H_BAR = FWD_H_STAGES * H_STAGE;
constexpr int FWD_H_BYTES = FWD_H_BAR + 2 * FWD_H_STAGES * 8 + 1024;  // + alignment slack
static_assert(FWD_H_BYTES <= (int)SMEM_LIMIT, "wide forward ring exceeds shared memory");

// dK/dV: the ring of DKV_H_STAGES stages, two 64 x 64 fp32 P^T tiles on
// their way from warpgroup 0 to warpgroup 1, then the barriers. A Q tile's
// items, in order: ceil(D / 64) S items (64 rows by 64 columns of K, Q, V
// and dO: four boxes) and the product items of the pass's 256 columns,
// first dO's, then Q's (64 rows, four boxes). At D = 512 a Q tile is ten
// items a pass (two passes), at D = 1024 eighteen (four passes); the ring
// is the same at every D.
constexpr int DKV_H_STAGES = 6;
constexpr int DKV_H_PT = H_ROWS * H_ROWS * 4;  // one fp32 P^T tile
constexpr int DKV_H_P = DKV_H_STAGES * H_STAGE;
constexpr int DKV_H_BAR = DKV_H_P + 2 * DKV_H_PT;
constexpr int DKV_H_BYTES = DKV_H_BAR + 2 * DKV_H_STAGES * 8 + 1024;  // + alignment slack
static_assert(DKV_H_BYTES <= (int)SMEM_LIMIT, "wide dK/dV ring exceeds shared memory");

// Named barriers of the P^T hand-off, over both consumer warpgroups: id
// PT_FULL + b when buffer b is written, PT_FREE + b when it has been read.
constexpr int PT_FULL = 1;
constexpr int PT_FREE = 3;

// dQ: the ring of DQ_H_STAGES stages, one 64 x 64 fp32 P tile on its way
// from warpgroup 0 to warpgroup 1, one 64 x 64 dS tile in T (the format of
// an S item's box: K-major, 128 B swizzle) that both warpgroups read, then
// the barriers. A key tile's items, in order: ceil(D / 64) S items (64 rows
// by 64 columns of Q, K, dO and V: four boxes) and one product item per
// consumer warpgroup (64 keys of K by its 256 output columns: four boxes).
// At D = 512 a key tile is ten items, at D = 1024 eighteen (two passes);
// the ring is the same at every D.
constexpr int DQ_H_STAGES = 6;
constexpr int DQ_H_P = DQ_H_STAGES * H_STAGE;
constexpr int DQ_H_DS = DQ_H_P + H_ROWS * H_ROWS * 4;
constexpr int DQ_H_BAR = DQ_H_DS + H_BOX_BYTES;
constexpr int DQ_H_BYTES = DQ_H_BAR + 2 * DQ_H_STAGES * 8 + 1024;  // + alignment slack
static_assert(DQ_H_BYTES <= (int)SMEM_LIMIT, "wide dQ ring exceeds shared memory");
static_assert(DQ_H_DS % 1024 == 0, "the dS tile starts on a 1024-byte boundary");

// Named barriers of dQ's exchange, over both consumer warpgroups: P_FULL
// once warpgroup 0 has written P, DS_FULL once warpgroup 1 has written dS.
// One buffer each is enough: warpgroup 0 writes the next P only after
// DS_FULL (warpgroup 1 has read this P), and warpgroup 1 the next dS only
// after P_FULL, which warpgroup 0 reaches after its product over this dS.
constexpr int P_FULL = 1;
constexpr int DS_FULL = 2;

// How many of the 64-column boxes at col0, col0 + 64, ... (at most n) start
// inside D: the ones a stage loads. The rest of its columns are past D;
// what the stage holds there reaches only output columns that are never
// stored.
__device__ __forceinline__ int boxes_in(int D, int col0, int n) {
  const int b = (D - col0 + H_BOX - 1) / H_BOX;
  return b < 0 ? 0 : (b > n ? n : b);
}

// Forward, persistent: a grid of one block per SM walks the work tiles
// (bh, 64 Q rows, pass of 512 output columns); o [BH, Sq, D] in T, lse
// [BH, Sq] fp32 (written by the first pass).
template <typename T>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                      float* __restrict__ lse, int BH, int Sq, int Sk, int D, float scale,
                      int causal, int q_offset, int k_offset) {
  using FS = TileFormat<H_BOX>;  // an S item's boxes: Q, then K, 64 rows x 64 columns
  using FV = TileFormat<H_OUT>;  // a V item: 64 keys x 256 columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Ring<H_STAGE> ring = make_ring<H_STAGE>(base, FWD_H_BAR, FWD_H_STAGES);
  __syncthreads();

  const int qtiles = (Sq + H_ROWS - 1) / H_ROWS;
  const int passes = (D + CONSUMER_WGS * H_OUT - 1) / (CONSUMER_WGS * H_OUT);
  const int chunks = (D + H_BOX - 1) / H_BOX;
  // Work tile w: pass w % passes, Q tile (w / passes) % qtiles, head
  // w / (passes qtiles); neighbours share a head's K and V in L2.
  const int nwork = BH * qtiles * passes;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per key tile its S items, then its V items.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int pass = w % passes;
        const int q0 = (w / passes) % qtiles * H_ROWS;
        const int bh = w / (passes * qtiles);
        const int n = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int t = 0; t < n; ++t) {
          for (int j = 0; j < chunks; ++j, ++it) {
            const uint32_t tile = ring.fill(it, 2 * H_BOX_BYTES);
            tma_load_3d(tile, &tm_q, ring.bar(it), H_BOX * j, q0, bh);
            tma_load_3d(tile + H_BOX_BYTES, &tm_k, ring.bar(it), H_BOX * j, t * H_ROWS, bh);
          }
          for (int u = 0; u < CONSUMER_WGS; ++u, ++it) {
            const int col0 = (CONSUMER_WGS * pass + u) * H_OUT;
            const int nb = boxes_in(D, col0, H_OUT / H_BOX);
            const uint32_t tile = ring.fill(it, nb * H_BOX_BYTES);
            for (int b = 0; b < nb; ++b)
              tma_load_3d(tile + b * H_BOX_BYTES, &tm_v, ring.bar(it), col0 + H_BOX * b,
                          t * H_ROWS, bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: all 64 rows of each work tile, output columns
    // [256 wg, 256 wg + 256) of its pass.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int pass = w % passes;
      const int q0 = (w / passes) % qtiles * H_ROWS;
      const int bh = w / (passes * qtiles);
      const int row0 = q0 + r;  // and row0 + 8
      const int col0 = (CONSUMER_WGS * pass + wg) * H_OUT;
      const int n = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
      float acc[H_OUT / 2];
#pragma unroll
      for (int i = 0; i < H_OUT / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};

      for (int t = 0; t < n; ++t) {
        // S = Q K^T (SS, both K-major) over the S items, one commit group
        // each; a stage is released once its group has completed.
        float sc[H_ROWS / 2];
#pragma unroll
        for (int i = 0; i < H_ROWS / 2; ++i) sc[i] = 0.f;
        for (int j = 0; j < chunks; ++j, ++it) {
          const uint32_t tile = ring.tile(it);
          ring.wait(it);
          fence_regs(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < H_BOX / 16; ++kk)
            Wgmma<H_ROWS, T>::template ss<0>(sc, FS::kmajor(tile, H_ROWS, 0, kk),
                                             FS::kmajor(tile + H_BOX_BYTES, H_ROWS, 0, kk));
          wgmma_commit();
          if (j > 0) {
            wgmma_wait<1>();
            ring.release(it - 1, lane);
          }
        }
        wgmma_wait<0>();
        fence_regs(sc);
        ring.release(it - 1, lane);

        float corr[2];
        uint32_t p[H_ROWS / 16][4];
        const int k0 = t * H_ROWS;
        if (k0 + H_ROWS > Sk || (causal && q_offset + q0 < k_offset + k0 + H_ROWS - 1))
          softmax_tile<T, H_ROWS, true>(sc, m, l, corr, p, row0, k0, Sk, sl2, causal, q_offset,
                                        k_offset, tq);
        else
          softmax_tile<T, H_ROWS, false>(sc, m, l, corr, p, row0, k0, Sk, sl2, causal, q_offset,
                                         k_offset, tq);
#pragma unroll
        for (int i = 0; i < H_OUT / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

        // O += P V over this warpgroup's V item (RS: P from registers, V
        // MN-major); the other warpgroup's item is waited for and released.
        for (int u = 0; u < CONSUMER_WGS; ++u, ++it) {
          ring.wait(it);
          if (u == wg) {
            const uint32_t tile = ring.tile(it);
            fence_regs(acc);
            fence_regs(p);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < H_ROWS / 16; ++kk)
              Wgmma<H_OUT, T>::template rs<1>(acc, p[kk], FV::mnmajor(tile, H_ROWS, kk));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
          }
          ring.release(it, lane);
        }
      }

      // O / l in T straight from registers; lse from the first pass.
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const bool empty = l[h] == 0.f;
        inv[h] = empty ? 0.f : 1.f / l[h];
        const int qi = row0 + 8 * h;
        if (pass == 0 && wg == 0 && tq == 0 && qi < Sq)
          lse[(size_t)bh * Sq + qi] = empty ? LSE_MASKED : m[h] * LN2 + logf(l[h]);
      }
      store_rows<T, H_OUT>(o + (size_t)bh * Sq * D + col0, D, acc, inv, row0, Sq, tq, D - col0);
    }
  }
}

// dK/dV, persistent: a grid of one block per SM walks the work tiles (bh,
// 64 keys, pass of 256 output columns) and loops over the Q tiles that can
// see the keys. dV = sum_i P_ij^T dO_i (warpgroup 0); dK = scale * sum_i
// dS_ij^T Q_i (warpgroup 1).
template <typename T>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, T* __restrict__ dk,
                      T* __restrict__ dv, const float* __restrict__ lse,
                      const float* __restrict__ delta, const float* __restrict__ glse, int BH,
                      int Sq, int Sk, int D, float scale, int causal, int q_offset,
                      int k_offset) {
  using FS = TileFormat<H_BOX>;  // an S item's boxes: K, Q, V, dO, 64 rows x 64 columns
  using FV = TileFormat<H_OUT>;  // a product item: dO or Q, 64 rows x 256 columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // the same base, generic
  const Ring<H_STAGE> ring = make_ring<H_STAGE>(base, DKV_H_BAR, DKV_H_STAGES);
  __syncthreads();

  const int ktiles = (Sk + H_ROWS - 1) / H_ROWS;
  const int qtiles = (Sq + H_ROWS - 1) / H_ROWS;
  const int passes = (D + H_OUT - 1) / H_OUT;
  const int chunks = (D + H_BOX - 1) / H_BOX;
  // Work tile w: pass w % passes, key tile (w / passes) % ktiles, head
  // w / (passes ktiles); neighbours share a head's Q and dO in L2.
  const int nwork = BH * ktiles * passes;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per Q tile its S items, then dO's and Q's
    // product items.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int pass = w % passes;
        const int k0 = (w / passes) % ktiles * H_ROWS;
        const int bh = w / (passes * ktiles);
        const int col0 = pass * H_OUT;
        const int nb = boxes_in(D, col0, H_OUT / H_BOX);
        for (int qt = first_query_tile(k0, causal, q_offset, k_offset); qt < qtiles; ++qt) {
          const int q0 = qt * H_ROWS;
          for (int j = 0; j < chunks; ++j, ++it) {
            const uint32_t tile = ring.fill(it, 4 * H_BOX_BYTES);
            const uint32_t bar = ring.bar(it);
            tma_load_3d(tile, &tm_k, bar, H_BOX * j, k0, bh);
            tma_load_3d(tile + H_BOX_BYTES, &tm_q, bar, H_BOX * j, q0, bh);
            tma_load_3d(tile + 2 * H_BOX_BYTES, &tm_v, bar, H_BOX * j, k0, bh);
            tma_load_3d(tile + 3 * H_BOX_BYTES, &tm_do, bar, H_BOX * j, q0, bh);
          }
          for (int u = 0; u < CONSUMER_WGS; ++u, ++it) {
            const uint32_t tile = ring.fill(it, nb * H_BOX_BYTES);
            for (int b = 0; b < nb; ++b)
              tma_load_3d(tile + b * H_BOX_BYTES, u == 0 ? &tm_do : &tm_q, ring.bar(it),
                          col0 + H_BOX * b, q0, bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: all 64 keys of each work tile; warpgroup 0
    // S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's keys r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    int it = 0;
    int pt = 0;  // Q tiles so far: the P^T buffer is pt % 2
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int pass = w % passes;
      const int k0 = (w / passes) % ktiles * H_ROWS;
      const int bh = w / (passes * ktiles);
      const int key0 = k0 + r;  // and key0 + 8
      float acc[H_OUT / 2];
#pragma unroll
      for (int i = 0; i < H_OUT / 2; ++i) acc[i] = 0.f;

      for (int qt = first_query_tile(k0, causal, q_offset, k_offset); qt < qtiles; ++qt, ++pt) {
        const int q0 = qt * H_ROWS;
        // This thread's 16 Q columns (element i of a score tile is column
        // 8 (i / 4) + 2 tq + i % 2, value e = 2 (i / 4) + i % 2): lse
        // log2(e) for warpgroup 0, g_lse - delta for warpgroup 1. Rows past
        // Sq get lse = LSE_MASKED: their P is exactly 0.
        float rv[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int qi = q0 + 8 * (e >> 1) + 2 * tq + (e & 1);
          const size_t at = (size_t)bh * Sq + qi;
          if (wg == 0)
            rv[e] = qi < Sq ? lse[at] * LOG2E : LSE_MASKED;
          else
            rv[e] = qi < Sq ? glse[at] - delta[at] : 0.f;
        }

        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), SS,
        // both K-major, one commit group per S item.
        float st[H_ROWS / 2];
#pragma unroll
        for (int i = 0; i < H_ROWS / 2; ++i) st[i] = 0.f;
        for (int j = 0; j < chunks; ++j, ++it) {
          const uint32_t a = ring.tile(it) + (wg == 0 ? 0 : 2 * H_BOX_BYTES);
          ring.wait(it);
          fence_regs(st);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < H_BOX / 16; ++kk)
            Wgmma<H_ROWS, T>::template ss<0>(st, FS::kmajor(a, H_ROWS, 0, kk),
                                             FS::kmajor(a + H_BOX_BYTES, H_ROWS, 0, kk));
          wgmma_commit();
          if (j > 0) {
            wgmma_wait<1>();
            ring.release(it - 1, lane);
          }
        }
        wgmma_wait<0>();
        fence_regs(st);
        ring.release(it - 1, lane);

        // P^T goes from warpgroup 0 to warpgroup 1 in fp32 (thread tid's
        // element i at i WG + tid: no bank conflicts), which forms dS^T;
        // each rounds its own to T as the A fragments of its product.
        const int b = pt & 1;
        float* sp = reinterpret_cast<float*>(smem + DKV_H_P + b * DKV_H_PT);
        if (wg == 0) {
          const bool mask = causal && q_offset + q0 < k_offset + k0 + H_ROWS - 1;
#pragma unroll
          for (int i = 0; i < H_ROWS / 2; ++i) {
            const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
            float pv = exp2f(fmaf(st[i], sl2, -rv[2 * (i >> 2) + (i & 1)]));
            if (mask && q_offset + q0 + c < k_offset + key0 + 8 * ((i >> 1) & 1)) pv = 0.f;
            st[i] = pv;
          }
          if (pt >= 2) named_sync(PT_FREE + b, 2 * WG);  // Q tile pt - 2's P^T has been read
#pragma unroll
          for (int i = 0; i < H_ROWS / 2; ++i) sp[i * WG + tid] = st[i];
          __threadfence_block();
          named_arrive(PT_FULL + b, 2 * WG);
        } else {
          named_sync(PT_FULL + b, 2 * WG);
#pragma unroll
          for (int i = 0; i < H_ROWS / 2; ++i)
            st[i] = sp[i * WG + tid] * (st[i] + rv[2 * (i >> 2) + (i & 1)]);
          __threadfence_block();
          named_arrive(PT_FREE + b, 2 * WG);
        }
        uint32_t frag[H_ROWS / 16][4];
#pragma unroll
        for (int kk = 0; kk < H_ROWS / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            frag[kk][x] = pack2<T>(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);

        // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), RS
        // with dO or Q MN-major, over this pass's columns; the other
        // warpgroup's item is waited for and released.
        for (int u = 0; u < CONSUMER_WGS; ++u, ++it) {
          ring.wait(it);
          if (u == wg) {
            const uint32_t tile = ring.tile(it);
            fence_regs(acc);
            fence_regs(frag);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < H_ROWS / 16; ++kk)
              Wgmma<H_OUT, T>::template rs<1>(acc, frag[kk], FV::mnmajor(tile, H_ROWS, kk));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
          }
          ring.release(it, lane);
        }
      }

      // dV, or scale dK, in T straight from registers; keys past Sk are not
      // written (so they needed no mask above).
      const float mul[2] = {wg == 0 ? 1.f : scale, wg == 0 ? 1.f : scale};
      const int col0 = pass * H_OUT;
      store_rows<T, H_OUT>((wg == 0 ? dv : dk) + (size_t)bh * Sk * D + col0, D, acc, mul, key0,
                           Sk, tq, D - col0);
    }
    // Close the phases of warpgroup 1's last two reads of P^T.
    if (wg == 0)
      for (int t = pt >= 2 ? pt - 2 : 0; t < pt; ++t) named_sync(PT_FREE + (t & 1), 2 * WG);
  }
}

// dQ, persistent: a grid of one block per SM walks the work tiles (bh,
// 64 Q rows, pass of 512 output columns) and loops over the key tiles their
// rows can see. Per key tile warpgroup 0 computes S = Q K^T and P,
// warpgroup 1 dP = dO V^T and, from P, dS rounded to T into shared memory;
// then each adds dS K of its own 256 columns to dQ. dq = scale * sum_j
// dS_j K_j, [BH, Sq, D] in T.
template <typename T>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, T* __restrict__ dq,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ glse, int BH, int Sq, int Sk, int D,
                     float scale, int causal, int q_offset, int k_offset) {
  using FS = TileFormat<H_BOX>;  // an S item's boxes (Q, K, dO, V) and the dS tile
  using FV = TileFormat<H_OUT>;  // a product item: K, 64 keys x 256 columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // the same base, generic
  const Ring<H_STAGE> ring = make_ring<H_STAGE>(base, DQ_H_BAR, DQ_H_STAGES);
  __syncthreads();

  const int qtiles = (Sq + H_ROWS - 1) / H_ROWS;
  const int passes = (D + CONSUMER_WGS * H_OUT - 1) / (CONSUMER_WGS * H_OUT);
  const int chunks = (D + H_BOX - 1) / H_BOX;
  // Work tile w: pass w % passes, Q tile (w / passes) % qtiles, head
  // w / (passes qtiles); neighbours share a head's K and V in L2.
  const int nwork = BH * qtiles * passes;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per key tile its S items, then its product
    // items.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int pass = w % passes;
        const int q0 = (w / passes) % qtiles * H_ROWS;
        const int bh = w / (passes * qtiles);
        const int n = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int t = 0; t < n; ++t) {
          const int k0 = t * H_ROWS;
          for (int j = 0; j < chunks; ++j, ++it) {
            const uint32_t tile = ring.fill(it, 4 * H_BOX_BYTES);
            const uint32_t bar = ring.bar(it);
            tma_load_3d(tile, &tm_q, bar, H_BOX * j, q0, bh);
            tma_load_3d(tile + H_BOX_BYTES, &tm_k, bar, H_BOX * j, k0, bh);
            tma_load_3d(tile + 2 * H_BOX_BYTES, &tm_do, bar, H_BOX * j, q0, bh);
            tma_load_3d(tile + 3 * H_BOX_BYTES, &tm_v, bar, H_BOX * j, k0, bh);
          }
          for (int u = 0; u < CONSUMER_WGS; ++u, ++it) {
            const int col0 = (CONSUMER_WGS * pass + u) * H_OUT;
            const int nb = boxes_in(D, col0, H_OUT / H_BOX);
            const uint32_t tile = ring.fill(it, nb * H_BOX_BYTES);
            for (int b = 0; b < nb; ++b)
              tma_load_3d(tile + b * H_BOX_BYTES, &tm_k, ring.bar(it), col0 + H_BOX * b, k0,
                          bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: all 64 rows of each work tile, output columns
    // [256 wg, 256 wg + 256) of its pass; warpgroup 0 S and P, warpgroup 1
    // dP and dS.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    float* const sp = reinterpret_cast<float*>(smem + DQ_H_P);
    const uint32_t sds = base + DQ_H_DS;
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int pass = w % passes;
      const int q0 = (w / passes) % qtiles * H_ROWS;
      const int bh = w / (passes * qtiles);
      const int row0 = q0 + r;  // and row0 + 8
      const int col0 = (CONSUMER_WGS * pass + wg) * H_OUT;
      const int n = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
      // This thread's two rows: lse log2(e) for warpgroup 0, g_lse - delta
      // for warpgroup 1. Rows past Sq get lse = LSE_MASKED: their P is
      // exactly 0.
      float rv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = row0 + 8 * h;
        const size_t at = (size_t)bh * Sq + qi;
        if (wg == 0)
          rv[h] = qi < Sq ? lse[at] * LOG2E : LSE_MASKED;
        else
          rv[h] = qi < Sq ? glse[at] - delta[at] : 0.f;
      }
      float acc[H_OUT / 2];
#pragma unroll
      for (int i = 0; i < H_OUT / 2; ++i) acc[i] = 0.f;

      for (int t = 0; t < n; ++t) {
        const int k0 = t * H_ROWS;
        // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), SS, both
        // K-major, one commit group per S item.
        float sc[H_ROWS / 2];
#pragma unroll
        for (int i = 0; i < H_ROWS / 2; ++i) sc[i] = 0.f;
        for (int j = 0; j < chunks; ++j, ++it) {
          const uint32_t a = ring.tile(it) + (wg == 0 ? 0 : 2 * H_BOX_BYTES);
          ring.wait(it);
          fence_regs(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < H_BOX / 16; ++kk)
            Wgmma<H_ROWS, T>::template ss<0>(sc, FS::kmajor(a, H_ROWS, 0, kk),
                                             FS::kmajor(a + H_BOX_BYTES, H_ROWS, 0, kk));
          wgmma_commit();
          if (j > 0) {
            wgmma_wait<1>();
            ring.release(it - 1, lane);
          }
        }
        wgmma_wait<0>();
        fence_regs(sc);
        ring.release(it - 1, lane);

        // P goes from warpgroup 0 to warpgroup 1 in fp32 (thread tid's
        // element i at i WG + tid: no bank conflicts), which forms dS =
        // P (dP + g_lse - delta) and writes it in T as the A operand of
        // both warpgroups' products. Keys past Sk read zero rows of K but
        // get P = 0, so that dS stays finite.
        if (wg == 0) {
          const bool mask =
              k0 + H_ROWS > Sk || (causal && q_offset + q0 < k_offset + k0 + H_ROWS - 1);
#pragma unroll
          for (int i = 0; i < H_ROWS / 2; ++i) {
            const int kj = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
            const int h = (i >> 1) & 1;
            float pv = exp2f(fmaf(sc[i], sl2, -rv[h]));
            if (mask && (kj >= Sk || (causal && q_offset + row0 + 8 * h < k_offset + kj)))
              pv = 0.f;
            sp[i * WG + tid] = pv;
          }
          __threadfence_block();
          named_arrive(P_FULL, 2 * WG);
        } else {
          named_sync(P_FULL, 2 * WG);
#pragma unroll
          for (int j = 0; j < H_ROWS / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h;
              const float d0 = sp[i * WG + tid] * (sc[i] + rv[h]);
              const float d1 = sp[(i + 1) * WG + tid] * (sc[i + 1] + rv[h]);
              st_shared_u32(sds + FS::offset(H_ROWS, r + 8 * h, 8 * j + 2 * tq),
                            pack2<T>(d0, d1));
            }
          fence_async_smem();  // the writes, visible to wgmma
        }
        named_sync(DS_FULL, 2 * WG);

        // dQ += dS K over this warpgroup's product item (SS: dS K-major, K
        // MN-major); the other warpgroup's item is waited for and released.
        for (int u = 0; u < CONSUMER_WGS; ++u, ++it) {
          ring.wait(it);
          if (u == wg) {
            const uint32_t tile = ring.tile(it);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < H_ROWS / 16; ++kk)
              Wgmma<H_OUT, T>::template ss<1>(acc, FS::kmajor(sds, H_ROWS, 0, kk),
                                              FV::mnmajor(tile, H_ROWS, kk));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
          }
          ring.release(it, lane);
        }
      }

      // scale dQ in T straight from registers; columns past D and rows past
      // Sq are not written.
      const float mul[2] = {scale, scale};
      store_rows<T, H_OUT>(dq + (size_t)bh * Sq * D + col0, D, acc, mul, row0, Sq, tq,
                           D - col0);
    }
  }
}

// The tensor map of a contiguous [BH, S, D] tensor of T in 64 x 64 boxes
// (128-byte rows, the 128 B swizzle); rows past S and columns past D read as
// zeros. D must be a multiple of 8 (16-byte rows).
template <typename T>
int wide_map(CUtensorMap* map, const void* base, int S, int BH, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)H_BOX, (cuuint32_t)H_ROWS, 1};
  return make_map<T>(map, base, 3, dims, strides, box, H_BOX * 2);
}

// A persistent grid: min(work tiles, SMs) blocks.
inline int persistent_grid(int nwork, dim3* grid) {
  int sms = 0;
  const int err = sm_count(&sms);
  *grid = dim3(nwork < sms ? nwork : sms);
  return err;
}

template <typename T>
int launch_fwd_hopper(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                      int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  if (D <= 0 || D % 8) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk)
    return fwd_empty(o, (size_t)BH * Sq * D * sizeof(T), lse, (long long)BH * Sq, stream);
  CUtensorMap mq, mk, mv;
  dim3 grid;
  int err;
  const int passes = (D + CONSUMER_WGS * H_OUT - 1) / (CONSUMER_WGS * H_OUT);
  if ((err = wide_map<T>(&mq, q, Sq, BH, D)) || (err = wide_map<T>(&mk, k, Sk, BH, D)) ||
      (err = wide_map<T>(&mv, v, Sk, BH, D)) ||
      (err = persistent_grid(BH * ((Sq + H_ROWS - 1) / H_ROWS) * passes, &grid)))
    return err;
  return launch(flash_fwd_wide_kernel<T>, grid, SM90_THREADS, FWD_H_BYTES, stream, mq, mk, mv,
                (T*)o, (float*)lse, BH, Sq, Sk, D, scale, causal, qo, ko);
}

template <typename T>
int launch_dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                      int BH, int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  if (D <= 0 || D % 8) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk) return zero_fill(stream, (size_t)BH * Sk * D * sizeof(T), dk, dv);
  CUtensorMap mq, mk, mv, mdo;
  dim3 grid;
  int err;
  const int passes = (D + H_OUT - 1) / H_OUT;
  if ((err = wide_map<T>(&mq, q, Sq, BH, D)) || (err = wide_map<T>(&mk, k, Sk, BH, D)) ||
      (err = wide_map<T>(&mv, v, Sk, BH, D)) || (err = wide_map<T>(&mdo, dout, Sq, BH, D)) ||
      (err = persistent_grid(BH * ((Sk + H_ROWS - 1) / H_ROWS) * passes, &grid)))
    return err;
  return launch(flash_dkv_wide_kernel<T>, grid, SM90_THREADS, DKV_H_BYTES, stream, mq, mk, mv,
                mdo, (T*)dk, (T*)dv, (const float*)lse, (const float*)delta, (const float*)glse,
                BH, Sq, Sk, D, scale, causal, qo, ko);
}

template <typename T>
int launch_dq_hopper(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse, void* dq, int BH,
                     int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                     cudaStream_t stream) {
  if (D <= 0 || D % 8) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk) return zero_fill(stream, (size_t)BH * Sq * D * sizeof(T), dq);
  CUtensorMap mq, mk, mv, mdo;
  dim3 grid;
  int err;
  const int passes = (D + CONSUMER_WGS * H_OUT - 1) / (CONSUMER_WGS * H_OUT);
  if ((err = wide_map<T>(&mq, q, Sq, BH, D)) || (err = wide_map<T>(&mk, k, Sk, BH, D)) ||
      (err = wide_map<T>(&mv, v, Sk, BH, D)) || (err = wide_map<T>(&mdo, dout, Sq, BH, D)) ||
      (err = persistent_grid(BH * ((Sq + H_ROWS - 1) / H_ROWS) * passes, &grid)))
    return err;
  return launch(flash_dq_wide_kernel<T>, grid, SM90_THREADS, DQ_H_BYTES, stream, mq, mk, mv, mdo,
                (T*)dq, (const float*)lse, (const float*)delta, (const float*)glse, BH, Sq, Sk,
                D, scale, causal, qo, ko);
}

}  // namespace

extern "C" {

int hvd_flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int Sq, int Sk, int D, int dtype, int causal, int q_offset, int k_offset,
                       float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch_fwd_hopper<bf16>(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, q_offset,
                                   k_offset, st);
  if (dtype == DTYPE_F16)
    return launch_fwd_hopper<f16>(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, q_offset,
                                  k_offset, st);
  if (dtype == DTYPE_F32)
    return launch_fwd_wide_3xtf32(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, q_offset,
                                  k_offset, st);
  return cudaErrorInvalidValue;
}

int hvd_flash_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dq, int BH,
                      int Sq, int Sk, int D, int dtype, int causal, int q_offset, int k_offset,
                      float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch_dq_hopper<bf16>(q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, D, scale,
                                  causal, q_offset, k_offset, st);
  if (dtype == DTYPE_F16)
    return launch_dq_hopper<f16>(q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, D, scale,
                                 causal, q_offset, k_offset, st);
  if (dtype == DTYPE_F32)
    return launch_dq_wide_3xtf32(q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, D, scale, causal,
                                 q_offset, k_offset, st);
  return cudaErrorInvalidValue;
}

// The bytes of scratch hvd_flash_dkv_wide needs on the current device (the
// float32 kernel's; bf16 and float16 take none), or -1.
long long hvd_flash_dkv_wide_scratch_bytes(int BH, int Sq, int Sk, int dtype) {
  return dtype == DTYPE_F32 ? wide_dkv_scratch_bytes(BH, Sq, Sk) : 0;
}

int hvd_flash_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                       void* scratch, long long scratch_bytes, int BH, int Sq, int Sk, int D,
                       int dtype, int causal, int q_offset, int k_offset, float scale,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch_dkv_hopper<bf16>(q, k, v, dout, lse, delta, glse, dk, dv, BH, Sq, Sk, D, scale,
                                   causal, q_offset, k_offset, st);
  if (dtype == DTYPE_F16)
    return launch_dkv_hopper<f16>(q, k, v, dout, lse, delta, glse, dk, dv, BH, Sq, Sk, D, scale,
                                  causal, q_offset, k_offset, st);
  if (dtype == DTYPE_F32)
    return launch_dkv_wide_3xtf32(q, k, v, dout, lse, delta, glse, dk, dv, scratch,
                                  scratch_bytes, BH, Sq, Sk, D, scale, causal, q_offset, k_offset,
                                  st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
