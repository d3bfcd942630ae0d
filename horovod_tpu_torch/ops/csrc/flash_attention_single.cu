// Single-tile flash attention for Hopper (sm_90a): a direct-softmax forward
// and a fused backward, for sequences of at most SMAX = 128 rows of Q and of
// K/V (SINGLE_TILE_MAX in horovod_tpu_torch/ops/attention.py, which routes
// longer sequences to the multi-tile kernels of flash_attention.cu).
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/attention.py:
//   flash_fwd_single_kernel (bf16, f16)
//                           <- _flash_fwd_single_kernel (:310)
//   flash_dqkv_kernel       (bf16, f16)
//                           <- _flash_dqkv_fused_kernel (:343)
// and, for float32, the 3xTF32 kernels of flash_attention_3xtf32.cu
// (flash_fwd_single_3xtf32_kernel, flash_dqkv_3xtf32_kernel).
//
// What bounds them, against the H100 SXM data-sheet peaks (989 TFLOP/s bf16,
// 3.35 TB/s, at its 700 W limit): at the BERT-Large phase-1 shape (sequence
// 128, batch 64, 16 heads: B*H = 1024, D = 64, bf16) the forward does
// 4.29 GFLOP over 67.6 MB (0.0202 ms, by bytes) and the fused backward
// 10.74 GFLOP over 119.0 MB (0.0355 ms, by bytes): both sit far below the
// ridge point (~295 FLOP per byte). The separate dQ and dK/dV kernels would
// move 187.8 MB at that shape; computing S -> P -> dP -> dS once and writing
// dQ, dK and dV from one pass reads every operand once.
//
// What the design does about it: the whole K and V of one (batch, head) sit
// in shared memory, so nothing is streamed twice and no running max or
// rescale is needed.
//   Forward, bf16 (flash_fwd_single_kernel): the Hopper design of the
//     multi-tile forward (flash_attention.cu, flash_hopper.cuh) with one
//     work tile per head. Persistent blocks, one per SM, walk the heads; a
//     producer thread loads each head's Q, K and V whole by TMA (128-row
//     boxes; rows past Sq or Sk read as zeros) into a ring of whole-head
//     buffers (four, two at D = 128), so the next heads' bytes arrive while
//     the current one computes, which is what a kernel bound by bytes needs.
//     Two consumer warpgroups own 64 Q rows each: S = Q K^T is one SS wgmma
//     chain (n128); the direct softmax runs on the accumulator registers
//     (row max and sum by quad shuffles, exp2 with the scale in one FMA, no
//     correction factor); O = P V is an RS wgmma with V MN-major; O / l
//     leaves through shared memory by a TMA store that runs on into the next
//     head, and lse is written directly.
//   Forward, float32: on the tensor cores in 3xTF32
//     (flash_attention_3xtf32.cu, flash_fwd_single_3xtf32_kernel): one work
//     tile a head, the head's K and V streaming past its resident Q while
//     the next heads' load, the direct softmax on one key tile of 128.
//   Backward, bf16 (flash_dqkv_kernel): the Hopper design of the multi-tile
//     dK/dV kernel (flash_attention.cu) with one work tile per head, which
//     also writes dQ. Persistent blocks walk the heads; the producer warp
//     loads a head's K and V whole by TMA (into a double buffer, so the next
//     head's arrive during this one; one buffer at D = 128, for shared
//     memory) and streams its Q and dO in stages of 64 rows (32 at
//     D = 128) with their lse and g_lse - delta rows. Each consumer
//     warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T (SS), P^T and
//     dS^T in registers, dV += P^T dO and dK += dS^T Q (RS), as in dK/dV.
//     dQ of a stage sums over all 128 keys, held by both warpgroups: each
//     writes its 64 rows of dS^T in bf16 to a shared dS^T tile (double
//     buffered), a named barrier joins the two, and dQ = scale dS K is one
//     wgmma chain from shared memory with dS^T as an MN-major A operand
//     (by the warpgroup whose turn it is, stages alternating), or at
//     D = 128, where the stage has 32 rows and wgmma's M is 64, as
//     dQ^T = K^T dS^T by both warpgroups (64 head-dim columns each, K
//     MN-major as A). The whole key range of a head is in the block, so no
//     atomics are needed. dQ, dK and dV leave through shared memory by TMA
//     stores (rows past Sq or Sk are not written).
//   Backward, float32: on the tensor cores in 3xTF32
//     (flash_attention_3xtf32.cu, flash_dqkv_3xtf32_kernel): one work tile
//     a head, its K and V resident while its Q and dO stream past in 64-row
//     tiles; each warp owns 16 keys (dK, dV in registers), and dQ of a Q
//     tile sums the warps' dS through a shared tile, as here.
// The Hopper kernels here are templated on the 2-byte type T (bf16 or
// float16: wgmma's kind, the tensor maps' data type, the rounding of P, dS
// and the outputs). Products take the stored dtype (bf16 or float16 on
// tensor cores by wgmma, fp32 accumulation), and P and dS are rounded to
// the operand dtype before the PV, P^T dO, dS K and dS^T Q products, as the
// TPU kernels do (float32: not rounded).
//
// Semantics (identical to the TPU kernels): causal masking on global
// positions q_offset + i >= k_offset + j; a row with no visible key gives
// O = 0 and lse = 1e30; dS = P * (dO V^T - delta + g_lse). Any Sq, Sk up to
// 128 works: rows and keys past the end are masked; with no key the forward
// gives O = 0, lse = 1e30 and dQ = 0, with no query dK = dV = 0
// (flash_hopper.cuh: fwd_empty, zero_fill).
//
// C interface: every entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launch (0 on success), or
// HVD_ERR_TENSOR_MAP + the CUresult if a tensor map cannot be encoded.

#include "flash_hopper.cuh"

// The float32 forward and fused backward on the tensor cores
// (flash_attention_3xtf32.cu): D = 32, 64 and 128 (the wrapper zero-pads
// D = 16 to 32; any other D: cudaErrorInvalidValue).
int launch_fwd_single_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse,
                             int BH, int Sq, int Sk, int D, float scale, int causal, int qo,
                             int ko, cudaStream_t stream);
int launch_dqkv_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* glse, void* dq, void* dk,
                       void* dv, int BH, int Sq, int Sk, int D, float scale, int causal, int qo,
                       int ko, cudaStream_t stream);

namespace {

constexpr int SMAX = 128;  // most rows of Q or of K/V

// ---------------------------------------------------------------------------
// Forward, bf16 on Hopper: o [BH, Sq, D] bf16, lse [BH, Sq] fp32.
// ---------------------------------------------------------------------------

// Shared memory of the forward, byte offsets from a 1024-aligned base: a
// ring of whole-head buffers (Q, K and V of one bh, SMAX rows each), and
// each consumer warpgroup's bf16 output tile on its way out by TMA. Four
// buffers, two at D = 128, where one buffer is 96 KB.
template <int D>
struct FwdSingleSmem {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int TILE = SMAX * D * 2;             // one operand of one head
  static constexpr int STAGE = 3 * TILE;                // Q, K, V at + 0, TILE, 2 TILE
  static constexpr int TILE_O = 64 * D * 2;
  static constexpr int O = STAGES * STAGE;              // + warpgroup * TILE_O
  static constexpr int BAR = O + CONSUMER_WGS * TILE_O;  // full[S], empty[S]
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
};

// Persistent: a grid of one block per SM walks the heads in turn. The
// producer runs ahead into the next heads' buffers while the consumers
// finish the current one.
template <typename T, int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_single_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int BH,
                        int Sq, int Sk, float scale, int causal, int q_offset, int k_offset) {
  using F = TileFormat<D>;
  using L = FwdSingleSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BAR;               // buffer s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * L::STAGES;   // buffer s at + 8 s
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per head its Q, K and V.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++it) {
        const int s = it % L::STAGES;
        const uint32_t bar = full_bar + 8 * s;
        const uint32_t sQ = base + s * L::STAGE;
        mbar_wait(empty_bar + 8 * s, ((it / L::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, L::STAGE);
        for (int b = 0; b < F::NB; ++b) {
          const uint32_t box = sQ + b * SMAX * F::ROW_BYTES;
          tma_load_3d(box, &tm_q, bar, b * F::CB, 0, bh);
          tma_load_3d(box + L::TILE, &tm_k, bar, b * F::CB, 0, bh);
          tma_load_3d(box + 2 * L::TILE, &tm_v, bar, b * F::CB, 0, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: Q rows [64 wg, 64 wg + 64) of each head.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int row_first = wg * 64;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    const int row0 = row_first + r;
    const float sl2 = scale * LOG2E;
    // Keys past Sk, or causally hidden keys of these rows: the same for every head.
    const bool masked = Sk < SMAX || (causal && q_offset + row_first < k_offset + SMAX - 1);
    int it = 0;
    for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++it) {
      const int s = it % L::STAGES;
      const uint32_t sQ = base + s * L::STAGE;
      const uint32_t sK = sQ + L::TILE;
      const uint32_t sV = sK + L::TILE;
      mbar_wait(full_bar + 8 * s, (it / L::STAGES) & 1);

      // S = Q K^T (SS, both K-major).
      float sc[SMAX / 2];
      wgmma_fence();
      Wgmma<SMAX, T>::template ss_init<0>(sc, F::kmajor(sQ, SMAX, row_first, 0),
                                       F::kmajor(sK, SMAX, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        Wgmma<SMAX, T>::template ss<0>(sc, F::kmajor(sQ, SMAX, row_first, kk),
                                    F::kmajor(sK, SMAX, 0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // The direct softmax: one tile, from m = NEG_INF and l = 0.
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};
      float corr[2];
      uint32_t p[SMAX / 16][4];
      if (masked)
        softmax_tile<T, SMAX, true>(sc, m, l, corr, p, row0, 0, Sk, sl2, causal, q_offset, k_offset,
                                 tq);
      else
        softmax_tile<T, SMAX, false>(sc, m, l, corr, p, row0, 0, Sk, sl2, causal, q_offset,
                                  k_offset, tq);

      // O = P V (RS: P from registers, V MN-major).
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SMAX / 16; ++kk)
        Wgmma<D, T>::template rs<1>(acc, p[kk], F::mnmajor(sV, SMAX, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);

      // O / l out by TMA (rows past Sq are not written); lse directly.
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const bool empty = l[h] == 0.f;
        inv[h] = empty ? 0.f : 1.f / l[h];
        const int qi = row0 + 8 * h;
        if (tq == 0 && qi < Sq)
          lse[(size_t)bh * Sq + qi] = empty ? LSE_MASKED : m[h] * LN2 + logf(l[h]);
      }
      store_out<T, D>(&tm_o, base + L::O + wg * L::TILE_O, acc, inv, r, tq, tid, wg, row_first, bh);
    }
    if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
  }
}

// ---------------------------------------------------------------------------
// Fused backward, bf16 on Hopper: dq [BH, Sq, D], dk and dv [BH, Sk, D]
// from one pass.
// ---------------------------------------------------------------------------

// Shared memory of the fused backward, byte offsets from a 1024-aligned
// base: the K/V buffers (two; one at D = 128), the ring of Q / dO stages,
// two dS^T tiles (SMAX key rows by BQ Q columns, TileFormat<BQ>), each
// consumer warpgroup's dK, dV and dQ tiles on their way out by TMA, and the
// stages' row vectors. BQ: Q rows of a stage; at D = 128 the 64 + 64 floats
// of dK and dV per thread leave registers for a 32-row stage only.
template <int D>
struct DqkvSmem {
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int KV_BUFS = D == 128 ? 1 : 2;
  static constexpr int TILE_KV = SMAX * D * 2;
  static constexpr int TILE_Q = BQ * D * 2;
  static constexpr int TILE_DS = SMAX * BQ * 2;
  static constexpr int TILE_O = 64 * D * 2;
  // dQ: 64 rows by D (D <= 64); at D = 128 BQ rows by the warpgroup's 64 columns.
  static constexpr int TILE_DQ = D == 128 ? BQ * 64 * 2 : 64 * D * 2;
  static constexpr int ROWS = 2 * BQ * 4;  // lse * log2(e), then g_lse - delta
  static constexpr int K = 0;                            // + buffer * 2 * TILE_KV
  static constexpr int V = K + TILE_KV;                  // + buffer * 2 * TILE_KV
  static constexpr int Q = KV_BUFS * 2 * TILE_KV;        // + stage * TILE_Q
  static constexpr int DO = Q + STAGES * TILE_Q;         // + stage * TILE_Q
  static constexpr int DS = DO + STAGES * TILE_Q;        // + buffer * TILE_DS
  static constexpr int OUT = DS + 2 * TILE_DS;           // dK, dV of warpgroup w at + 2 w TILE_O
  static constexpr int DQ = OUT + 4 * TILE_O;            // + warpgroup * TILE_DQ
  static constexpr int ROW = DQ + CONSUMER_WGS * TILE_DQ;  // + stage * ROWS
  static constexpr int BAR = ROW + STAGES * ROWS;  // full[S], empty[S], kv_full[B], kv_empty[B]
  static constexpr int BYTES = BAR + (2 * STAGES + 2 * KV_BUFS) * 8 + 1024;  // + alignment slack
};

// Named barrier of the two consumer warpgroups (store_out uses 1 and 2).
constexpr int DS_BARRIER = 3;

// P^T and dS^T of one Q stage on a consumer thread's registers (keys key0
// and key0 + 8, Q columns q0 + c): P^T = exp(S^T scale - lse[c]), dS^T =
// P^T (dP^T + g_lse[c] - delta[c]), as bf16 A fragments. MASK: keys past
// Sk (zero rows of K and V, but dS K reads their dS, so it must be 0) or
// causally hidden keys; set before exp2 is taken into account, so a
// non-finite exp2 never meets the mask. Rows past Sq have lse = LSE_MASKED.
template <typename T, int BQ, bool MASK>
__device__ __forceinline__ void dqkv_probs(const float (&st)[BQ / 2], const float (&dpt)[BQ / 2],
                                           const float* rows, uint32_t (&pf)[BQ / 16][4],
                                           uint32_t (&dsf)[BQ / 16][4], int key0, int q0, int Sk,
                                           float sl2, int causal, int q_offset, int k_offset,
                                           int tq) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * kk + 2 * r + e;
        const int c = 8 * (i >> 2) + 2 * tq + e;
        const int key = key0 + 8 * (r & 1);
        p[e] = exp2f(fmaf(st[i], sl2, -rows[c]));
        if (MASK && (key >= Sk || (causal && q_offset + q0 + c < k_offset + key))) p[e] = 0.f;
        ds[e] = p[e] * (dpt[i] + rows[BQ + c]);
      }
      pf[kk][r] = pack2<T>(p[0], p[1]);
      dsf[kk][r] = pack2<T>(ds[0], ds[1]);
    }
}

// Persistent: a grid of one block per SM walks the heads in turn and loops
// over their Q stages. dV = sum_i P_ij^T dO_i; dK = scale sum_i dS_ij^T Q_i;
// dQ = scale sum_j dS_ij K_j.
template <typename T, int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dqkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_dq,
                  const __grid_constant__ CUtensorMap tm_dk,
                  const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ lse,
                  const float* __restrict__ delta, const float* __restrict__ glse, int BH, int Sq,
                  int Sk, float scale, int causal, int q_offset, int k_offset) {
  using F = TileFormat<D>;
  using L = DqkvSmem<D>;
  constexpr int BQ = L::BQ;
  using FQ = TileFormat<BQ>;  // the dS^T tile: Q columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // the same base, generic
  const uint32_t full_bar = base + L::BAR;                       // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * L::STAGES;          // stage s at + 8 s
  const uint32_t kv_full_bar = empty_bar + 8 * L::STAGES;       // buffer b at + 8 b
  const uint32_t kv_empty_bar = kv_full_bar + 8 * L::KV_BUFS;   // buffer b at + 8 b
  const int n = (Sq + BQ - 1) / BQ;  // Q stages of every head (rows that see no key get dQ = 0)
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 32);  // the producer warp's lanes (row vectors, then TMA)
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    for (int b = 0; b < L::KV_BUFS; ++b) {
      mbar_init(kv_full_bar + 8 * b, 1);
      mbar_init(kv_empty_bar + 8 * b, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, first warp: per head its K and V, then the ring of Q / dO
    // stages and their row vectors.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 == CONSUMER_WGS * 4) {
      const int lane = threadIdx.x & 31;
      int qt = 0;  // Q stages loaded so far: the ring position
      int it = 0;
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++it) {
        const int kb = it % L::KV_BUFS;
        mbar_wait(kv_empty_bar + 8 * kb, ((it / L::KV_BUFS) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t bar = kv_full_bar + 8 * kb;
          const uint32_t sK = base + L::K + kb * 2 * L::TILE_KV;
          mbar_arrive_expect_tx(bar, 2 * L::TILE_KV);
          for (int b = 0; b < F::NB; ++b) {
            tma_load_3d(sK + b * SMAX * F::ROW_BYTES, &tm_k, bar, b * F::CB, 0, bh);
            tma_load_3d(sK + L::TILE_KV + b * SMAX * F::ROW_BYTES, &tm_v, bar, b * F::CB, 0, bh);
          }
        }
        const float* lse_b = lse + (size_t)bh * Sq;
        const float* delta_b = delta + (size_t)bh * Sq;
        const float* glse_b = glse + (size_t)bh * Sq;
        for (int t = 0; t < n; ++t, ++qt) {
          const int s = qt % L::STAGES;
          const int q0 = t * BQ;
          const uint32_t bar = full_bar + 8 * s;
          mbar_wait(empty_bar + 8 * s, ((qt / L::STAGES) & 1) ^ 1);
          // Rows past Sq get lse = LSE_MASKED: their P is exactly 0.
          float* rows = reinterpret_cast<float*>(smem + L::ROW + s * L::ROWS);
          for (int r = lane; r < BQ; r += 32) {
            const int qi = q0 + r;
            const bool in = qi < Sq;
            rows[r] = in ? lse_b[qi] * LOG2E : LSE_MASKED;
            rows[BQ + r] = in ? glse_b[qi] - delta_b[qi] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(bar, 2 * L::TILE_Q);
            const uint32_t sQ = base + L::Q + s * L::TILE_Q;
            const uint32_t sdO = base + L::DO + s * L::TILE_Q;
            for (int b = 0; b < F::NB; ++b) {
              tma_load_3d(sQ + b * BQ * F::ROW_BYTES, &tm_q, bar, b * F::CB, q0, bh);
              tma_load_3d(sdO + b * BQ * F::ROW_BYTES, &tm_do, bar, b * F::CB, q0, bh);
            }
          } else {
            mbar_arrive(bar);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys [64 wg, 64 wg + 64) of each head.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    const int key_first = wg * 64;
    const int key0 = key_first + r;  // and key0 + 8
    const float sl2 = scale * LOG2E;
    int qt = 0;
    int it = 0;
    for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++it) {
      const int kb = it % L::KV_BUFS;
      const uint32_t sK = base + L::K + kb * 2 * L::TILE_KV;
      const uint32_t sV = sK + L::TILE_KV;
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk_acc[i] = 0.f;
        dv_acc[i] = 0.f;
      }

      mbar_wait(kv_full_bar + 8 * kb, (it / L::KV_BUFS) & 1);
      for (int t = 0; t < n; ++t, ++qt) {
        const int s = qt % L::STAGES;
        const int q0 = t * BQ;
        const uint32_t sQ = base + L::Q + s * L::TILE_Q;
        const uint32_t sdO = base + L::DO + s * L::TILE_Q;
        const uint32_t sDS = base + L::DS + (qt & 1) * L::TILE_DS;
        mbar_wait(full_bar + 8 * s, (qt / L::STAGES) & 1);

        // S^T = K Q^T and dP^T = V dO^T (SS, all K-major).
        float st[BQ / 2], dpt[BQ / 2];
        wgmma_fence();
        Wgmma<BQ, T>::template ss_init<0>(st, F::kmajor(sK, SMAX, key_first, 0),
                                       F::kmajor(sQ, BQ, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BQ, T>::template ss<0>(st, F::kmajor(sK, SMAX, key_first, kk),
                                    F::kmajor(sQ, BQ, 0, kk));
        Wgmma<BQ, T>::template ss_init<0>(dpt, F::kmajor(sV, SMAX, key_first, 0),
                                       F::kmajor(sdO, BQ, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BQ, T>::template ss<0>(dpt, F::kmajor(sV, SMAX, key_first, kk),
                                    F::kmajor(sdO, BQ, 0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        const float* rows = reinterpret_cast<const float*>(smem + L::ROW + s * L::ROWS);
        uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
        if (key_first + 64 > Sk || (causal && q_offset + q0 < k_offset + key_first + 63))
          dqkv_probs<T, BQ, true>(st, dpt, rows, pf, dsf, key0, q0, Sk, sl2, causal, q_offset,
                               k_offset, tq);
        else
          dqkv_probs<T, BQ, false>(st, dpt, rows, pf, dsf, key0, q0, Sk, sl2, causal, q_offset,
                                k_offset, tq);

        // This warpgroup's 64 rows of dS^T into the stage's dS^T tile (the
        // tile two stages back was last read before the barrier below was
        // passed at the previous stage).
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            st_shared_u32(sDS + FQ::offset(SMAX, key0 + 8 * (j & 1), 16 * kk + 8 * (j >> 1) + 2 * tq),
                          dsf[kk][j]);
        fence_async_smem();

        // dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major).
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pf);
        fence_regs(dsf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<D, T>::template rs<1>(dv_acc, pf[kk], F::mnmajor(sdO, BQ, kk));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<D, T>::template rs<1>(dk_acc, dsf[kk], F::mnmajor(sQ, BQ, kk));
        wgmma_commit();

        // Both warpgroups' dS^T rows are in the tile.
        named_sync(DS_BARRIER, CONSUMER_WGS * WG);
        if constexpr (D == 128) {
          // dQ^T = K^T dS^T: this warpgroup's 64 head-dim columns (box wg
          // of K, MN-major as A) by the stage's BQ rows.
          float dqt[BQ / 2];
          const uint32_t sKb = sK + wg * SMAX * F::ROW_BYTES;
          wgmma_fence();
          Wgmma<BQ, T>::template ss_init<1, 1>(dqt, F::mnmajor(sKb, SMAX, 0),
                                            FQ::mnmajor(sDS, SMAX, 0));
#pragma unroll
          for (int kk = 1; kk < SMAX / 16; ++kk)
            Wgmma<BQ, T>::template ss<1, 1>(dqt, F::mnmajor(sKb, SMAX, kk),
                                         FQ::mnmajor(sDS, SMAX, kk));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk_acc);
          fence_regs(dv_acc);
          fence_regs(dqt);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_bar + 8 * s);
          // Transposed into the warpgroup's BQ x 64 dQ tile, out by TMA.
          using FO = TileFormat<64>;
          const uint32_t sdQ = base + L::DQ + wg * L::TILE_DQ;
          if (tid == 0) bulk_wait_read<0>();
          named_sync(1 + wg, WG);
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i)
            st_shared_16<T>(sdQ + FO::offset(BQ, 8 * (i >> 2) + 2 * tq + (i & 1),
                                            r + 8 * ((i >> 1) & 1)),
                           scale * dqt[i]);
          fence_async_smem();
          named_sync(1 + wg, WG);
          if (tid == 0) {
            tma_store_3d(&tm_dq, sdQ, wg * 64, q0, bh);
            bulk_commit();
          }
        } else {
          // dQ = dS K (SS: dS^T MN-major as A, K MN-major), by the
          // warpgroup whose turn it is.
          if (wg == (qt & 1)) {
            float dq[D / 2];
            wgmma_fence();
            Wgmma<D, T>::template ss_init<1, 1>(dq, FQ::mnmajor(sDS, SMAX, 0),
                                             F::mnmajor(sK, SMAX, 0));
#pragma unroll
            for (int kk = 1; kk < SMAX / 16; ++kk)
              Wgmma<D, T>::template ss<1, 1>(dq, FQ::mnmajor(sDS, SMAX, kk),
                                          F::mnmajor(sK, SMAX, kk));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dk_acc);
            fence_regs(dv_acc);
            fence_regs(dq);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_bar + 8 * s);
            const float mul[2] = {scale, scale};
            store_out<T, D>(&tm_dq, base + L::DQ + wg * L::TILE_DQ, dq, mul, r, tq, tid, wg, q0,
                         bh);
          } else {
            wgmma_wait<0>();
            fence_regs(dk_acc);
            fence_regs(dv_acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_bar + 8 * s);
          }
        }
      }
      // K and V were last read by this head's dQ products.
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty_bar + 8 * kb);

      // dK and dV in bf16 through the warpgroup's output tiles and TMA
      // stores, which run on while the next head starts. Keys past Sk are
      // not written.
      const uint32_t sdK = base + L::OUT + 2 * wg * L::TILE_O;
      const uint32_t sdV = sdK + L::TILE_O;
      if (tid == 0) bulk_wait_read<0>();  // the last stores have read them
      named_sync(1 + wg, WG);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * h;
          const uint32_t at = F::offset(64, r + 8 * h, 8 * j + 2 * tq);
          st_shared_u32(sdK + at, pack2<T>(scale * dk_acc[i], scale * dk_acc[i + 1]));
          st_shared_u32(sdV + at, pack2<T>(dv_acc[i], dv_acc[i + 1]));
        }
      fence_async_smem();
      named_sync(1 + wg, WG);
      if (tid == 0) {
        for (int b = 0; b < F::NB; ++b) {
          tma_store_3d(&tm_dk, sdK + b * 64 * F::ROW_BYTES, b * F::CB, key_first, bh);
          tma_store_3d(&tm_dv, sdV + b * 64 * F::ROW_BYTES, b * F::CB, key_first, bh);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
  }
}

template <typename T, int D>
int launch_fwd_single(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                      int Sq, int Sk, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  if (Sq > SMAX || Sk > SMAX) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk)
    return fwd_empty(o, (size_t)BH * Sq * D * sizeof(T), lse, (long long)BH * Sq, stream);
  if constexpr (!std::is_same<T, float>::value) {
    static_assert(FwdSingleSmem<D>::BYTES <= SMEM_LIMIT, "forward buffers exceed shared memory");
    CUtensorMap mq, mk, mv, mo;
    int err;
    if ((err = make_tile_map<T, D>(&mq, q, Sq, BH, SMAX)) ||
        (err = make_tile_map<T, D>(&mk, k, Sk, BH, SMAX)) ||
        (err = make_tile_map<T, D>(&mv, v, Sk, BH, SMAX)) ||
        (err = make_tile_map<T, D>(&mo, o, Sq, BH, 64)))
      return err;
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    return launch(flash_fwd_single_kernel<T, D>, dim3(BH < sms ? BH : sms), SM90_THREADS,
                  FwdSingleSmem<D>::BYTES, stream, mq, mk, mv, mo, (float*)lse, BH, Sq, Sk,
                  scale, causal, qo, ko);
  } else {
    return launch_fwd_single_3xtf32(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, qo, ko,
                                    stream);
  }
}

template <typename T, int D>
int launch_dqkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* glse, void* dq, void* dk, void* dv, int BH, int Sq,
                int Sk, float scale, int causal, int qo, int ko, cudaStream_t stream) {
  if (Sq > SMAX || Sk > SMAX) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk) {  // dQ = 0 with no key, dK = dV = 0 with no query
    const int err = zero_fill(stream, (size_t)BH * Sq * D * sizeof(T), dq);
    return err ? err : zero_fill(stream, (size_t)BH * Sk * D * sizeof(T), dk, dv);
  }
  if constexpr (!std::is_same<T, float>::value) {
    using L = DqkvSmem<D>;
    static_assert(L::BYTES <= SMEM_LIMIT, "backward buffers exceed shared memory");
    CUtensorMap mq, mk, mv, mdo, mdq, mdk, mdv;
    int err;
    if ((err = make_tile_map<T, D>(&mq, q, Sq, BH, L::BQ)) ||
        (err = make_tile_map<T, D>(&mk, k, Sk, BH, SMAX)) ||
        (err = make_tile_map<T, D>(&mv, v, Sk, BH, SMAX)) ||
        (err = make_tile_map<T, D>(&mdo, dout, Sq, BH, L::BQ)) ||
        (err = make_tile_map<T, D>(&mdq, dq, Sq, BH, D == 128 ? L::BQ : 64)) ||
        (err = make_tile_map<T, D>(&mdk, dk, Sk, BH, 64)) ||
        (err = make_tile_map<T, D>(&mdv, dv, Sk, BH, 64)))
      return err;
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    return launch(flash_dqkv_kernel<T, D>, dim3(BH < sms ? BH : sms), SM90_THREADS, L::BYTES, stream,
                  mq, mk, mv, mdo, mdq, mdk, mdv, (const float*)lse, (const float*)delta,
                  (const float*)glse, BH, Sq, Sk, scale, causal, qo, ko);
  } else {
    return launch_dqkv_3xtf32(q, k, v, dout, lse, delta, glse, dq, dk, dv, BH, Sq, Sk, D, scale,
                              causal, qo, ko, stream);
  }
}

}  // namespace

extern "C" {

int hvd_flash_fwd_single(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                         int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                         int k_offset, float scale, void* stream) {
  HVD_DISPATCH(dtype, D,
               (launch_fwd_single<T, HD>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, q_offset,
                                         k_offset, (cudaStream_t)stream)));
}

int hvd_flash_dqkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* glse, void* dq, void* dk,
                   void* dv, int BH, int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                   int k_offset, float scale, void* stream) {
  HVD_DISPATCH(dtype, D,
               (launch_dqkv<T, HD>(q, k, v, dout, lse, delta, glse, dq, dk, dv, BH, Sq, Sk, scale,
                                   causal, q_offset, k_offset, (cudaStream_t)stream)));
}

}  // extern "C"
