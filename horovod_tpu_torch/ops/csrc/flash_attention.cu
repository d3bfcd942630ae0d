// Flash attention for Hopper (sm_90a): the multi-tile forward, dQ and dK/dV
// kernels. horovod_tpu_torch/ops/attention.py routes here when Sq or Sk is
// above SINGLE_TILE_MAX (128 rows); shorter sequences go to the single-tile
// kernels of flash_attention_single.cu.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/attention.py:
//   flash_fwd_kernel  (bf16, f16)                        <- _flash_fwd_kernel (:138)
//   flash_dq_kernel   (bf16, f16)                        <- _flash_dq_kernel (:198)
//   flash_dkv_kernel  (bf16, f16)                        <- _flash_dkv_kernel (:252)
// and, for float32, the 3xTF32 kernels of flash_attention_3xtf32.cu.
//
// What bounds them, against the H100 SXM data-sheet peaks (989 TFLOP/s bf16,
// 3.35 TB/s, at its 700 W limit): at the BERT-Large S = 512 shape
// (B*H = 128, D = 64, bf16) the forward does 8.59 GFLOP over 33.8 MB, about
// 254 FLOP per byte, below the card's ridge point (~295 FLOP per byte), so it
// is bound by bytes; dQ (12.88 GFLOP over 42.7 MB) and dK/dV (17.18 GFLOP
// over 51.1 MB) sit above the ridge and are bound by tensor-core operations.
// Either way the products must run at a large share of the tensor cores'
// rate, which on Hopper only wgmma reaches, and the score matrix (S^2 per
// head) must never reach device memory.
//
// What the design does about it. The TPU's sequential grid axis becomes a
// loop inside one thread block, and each output tile has one owner, so no
// atomics are needed. bf16 and float16, the training path (flash_fwd_kernel,
// flash_dq_kernel, flash_dkv_kernel, templated on the 2-byte type T, which
// picks wgmma's .bf16 or .f16 kind, the tensor maps' data type and the
// rounding of P, dS and the outputs):
//   - Persistent blocks, one per SM, walk the work tiles: the forward's and
//     dQ's (bh, 128 Q rows), dK/dV's (bh, 128 keys). A block is three
//     warpgroups: two consumers of 64 rows each, and a producer whose first
//     warp keeps TMA loads in flight and which gives its registers to the
//     consumers (setmaxnreg; flash_hopper.cuh). The producer runs ahead into
//     the next work tile, its resident operands (Q; Q and dO; K and V) into
//     a second buffer and its streamed tiles into a ring of stages with
//     full/empty mbarriers (four; two for dQ and dK/dV at D = 128), so only
//     a block's first work tile waits for device memory.
//   - Operand tiles arrive by TMA in the swizzled format of sm90.cuh, from a
//     3-D tensor map (D, S, BH): rows past the sequence end read as zeros and
//     never as the next head's rows.
//   - Every product is a wgmma: S = Q K^T from shared memory (SS); O += P V
//     with P in registers (RS). Scores, the online-softmax state (a thread
//     holds 2 rows; row max and sum take two shuffles in its quad; exp2 with
//     the scale folded into one FMA), P and the accumulators O, dK, dV live
//     in registers. The two consumer warpgroups run on the same stages with
//     nothing ordering them; named barriers that made them take turns at
//     the tensor cores measured slower (the D = 256 forward, PERF.md).
//   - Forward: K/V stages of 128 rows (64 at D = 128, for shared memory). O
//     leaves through shared memory and a TMA store that runs on while the
//     next work tile starts.
//   - dQ: the forward's structure with the softmax statistics given. Q and
//     dO stay resident; K/V stages of 64 rows stream past them (for
//     registers: S and dP take 32 floats each, dQ up to 64), ending at the
//     last key a causal row can see. S = Q K^T and dP = dO V^T (SS), then
//     P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP + g_lse -
//     delta) in registers, each thread's two rows of lse and g_lse - delta
//     loaded one work tile ahead; dQ += dS K (RS, K MN-major) accumulates
//     in registers across the K/V tiles, and scale dQ leaves as O does.
//   - dK/dV: Q and dO tiles of 64 rows (32 at D = 128, for registers) stream
//     with their lse and g_lse - delta rows past the resident K and V, in
//     the transposed form: S^T = K Q^T and dP^T = V dO^T (SS), then
//     dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major). dK and dV
//     leave through shared memory and TMA stores, as O does.
// Head dim 256 (instances for D = 129 to 256, zero-padded): outputs leave
// straight from registers, 16 bytes a thread (store_rows), since the
// operand tiles double. The forward keeps two Q buffers and streams K and
// V as separate 64-row items of a three-item ring (S = Q K^T starts once K
// has landed). dQ and dK/dV keep one resident buffer and two stages: dQ's 32-row K/V stages, and dK/dV over one half of D's
// output columns per work tile, recomputing S^T and dP^T for each half (the
// 256 columns of dK and dV do not fit the consumers' registers at once).
// The *Smem layouts give the numbers.
// float32: the forward, dQ and dK/dV at every head dim run on the tensor
// cores in 3xTF32, which holds float32's tolerance
// (flash_attention_3xtf32.cu: launch_fwd_3xtf32, launch_dq_3xtf32,
// launch_dkv_3xtf32; instances at D = 32 to 256, D = 16 zero-padded to 32
// by the wrapper, so the D = 16 float32 launch is refused).
// P and dS are rounded to the operand dtype before the PV, P^T dO, dS K and
// dS^T Q products, as the TPU kernels do (float32: not rounded).
//
// Semantics (identical to the TPU kernels): causal masking on global
// positions q_offset + i >= k_offset + j; a row with no visible key gives
// O = 0 and lse = 1e30; the backward takes the cotangent of lse (g_lse) into
// dS = P * (dO V^T - delta + g_lse). Rows and keys past the sequence end are
// masked, so any sequence length works. With no key (Sk = 0) the forward
// gives O = 0 and lse = 1e30 and dQ is 0; with no query (Sq = 0) dK and dV
// are 0 (flash_hopper.cuh: fwd_empty, zero_fill; lse by this file's one
// fill kernel, flash_fwd_no_key_kernel), on every route.
//
// C interface: every entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launch (0 on success), or
// HVD_ERR_TENSOR_MAP + the CUresult if a tensor map cannot be encoded.

#include <math.h>
#include <stdio.h>

#include "flash_hopper.cuh"

// float32 on the tensor cores (flash_attention_3xtf32.cu): the forward, dQ
// and dK/dV at D = 32 to 256 (any other D: cudaErrorInvalidValue).
int launch_fwd_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                      int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                      cudaStream_t stream);
int launch_dq_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse, void* dq, int BH,
                     int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                     cudaStream_t stream);
int launch_dkv_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                      int BH, int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                      cudaStream_t stream);

namespace {

// Key rows [0, kend) can be visible to Q rows [q0, q0 + rows).
__device__ __forceinline__ int key_end(int Sk, int q0, int rows, int causal, int q_offset,
                                       int k_offset) {
  if (!causal) return Sk;
  const int last = q_offset - k_offset + q0 + rows;  // one past the last visible key
  return last < Sk ? (last > 0 ? last : 0) : Sk;
}

// First start of a bq-row Q tile whose rows can see key row k0 or later.
__device__ __forceinline__ int query_begin(int k0, int bq, int causal, int q_offset,
                                           int k_offset) {
  if (!causal) return 0;
  const int first = k_offset + k0 - q_offset;
  return first > 0 ? (first / bq) * bq : 0;
}

// ===========================================================================
// bf16 and float16 on Hopper: warp-specialized wgmma kernels.
// ===========================================================================

constexpr int FWD_BQ = 128;  // Q rows of a forward work tile

// Shared memory of the forward at D = 16 to 128, byte offsets from a
// 1024-aligned base: the Q buffers (two: the next work tile's Q loads while
// the current one runs), the K/V ring of STAGES stages, and each consumer
// warpgroup's output tile on its way out by TMA. BK: K/V rows of a ring
// stage, 128, or 64 at D = 128, where four 128-row stages would not fit
// beside the rest.
template <int D>
struct FwdSmem {
  static constexpr int BK = D >= 128 ? 64 : 128;
  static constexpr int STAGES = 4;
  static constexpr int TILE_Q = FWD_BQ * D * 2;
  static constexpr int TILE_KV = BK * D * 2;
  static constexpr int TILE_O = 64 * D * 2;
  static constexpr int Q = 0;                            // + buffer * TILE_Q
  static constexpr int K = Q + 2 * TILE_Q;               // + stage * TILE_KV
  static constexpr int V = K + STAGES * TILE_KV;         // + stage * TILE_KV
  static constexpr int O = V + STAGES * TILE_KV;         // + warpgroup * TILE_O
  static constexpr int BAR = O + CONSUMER_WGS * TILE_O;  // full[S], empty[S], q_full[2], q_empty[2]
  static constexpr int BYTES = BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
};

// At D = 256 a 128-row Q tile is 64 KB and a 64-row K or V tile 32 KB. Two
// Q buffers (the next work tile's Q loads while the current one runs) and a
// ring of three items, K and V apart (each with its own full/empty
// barriers, so S = Q K^T starts as soon as K has landed, and K's slot takes
// the next item while the softmax and P V run), take 224 KB. O leaves
// straight from registers (store_rows, 16 bytes a thread): 64 KB of
// output tiles would not fit beside the rest.
template <>
struct FwdSmem<256> {
  static constexpr int BK = 64;
  static constexpr int ITEMS = 3;
  static constexpr int TILE_Q = FWD_BQ * 256 * 2;
  static constexpr int TILE_KV = BK * 256 * 2;
  static constexpr int Q = 0;                       // + buffer * TILE_Q
  static constexpr int KV = Q + 2 * TILE_Q;         // + item slot * TILE_KV
  static constexpr int BAR = KV + ITEMS * TILE_KV;  // full[I], empty[I], q_full[2], q_empty[2]
  static constexpr int BYTES = BAR + (2 * ITEMS + 4) * 8 + 1024;  // + alignment slack
};
static_assert(FwdSmem<128>::BYTES <= (int)SMEM_LIMIT, "D = 128 forward exceeds shared memory");
static_assert(FwdSmem<256>::BYTES <= (int)SMEM_LIMIT, "D = 256 forward exceeds shared memory");

// The D = 256 forward's work, called by flash_fwd_kernel<T, 256>: the work
// tiles of D <= 128, with K(t) and V(t) as ring items 2t and 2t + 1. Per key
// tile a consumer warpgroup runs S = Q K(t)^T, the softmax, then
// O += P V(t), as at D <= 128. (Issuing S(t + 1) before the softmax of S(t),
// or having the warpgroups take turns at the tensor cores, measured slower:
// PERF.md.)
template <typename T>
__device__ __forceinline__ void flash_fwd_256(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v, T* __restrict__ o,
                                              float* __restrict__ lse, int BH, int Sq, int Sk,
                                              float scale, int causal, int q_offset,
                                              int k_offset) {
  constexpr int D = 256;
  using F = TileFormat<D>;
  using L = FwdSmem<D>;
  constexpr int BK = L::BK;
  constexpr int ITEMS = L::ITEMS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BAR;            // item slot s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * ITEMS;    // item slot s at + 8 s
  const uint32_t q_full_bar = empty_bar + 8 * ITEMS;  // buffer b at + 8 b
  const uint32_t q_empty_bar = q_full_bar + 16;       // buffer b at + 8 b

  const int qtiles = (Sq + FWD_BQ - 1) / FWD_BQ;
  const int nwork = BH * qtiles;  // consecutive work tiles share a head's K/V in L2
  auto ntiles = [&](int w) {
    return (key_end(Sk, (w % qtiles) * FWD_BQ, FWD_BQ, causal, q_offset, k_offset) + BK - 1) /
           BK;
  };
  // Ring item `it` (K or V of one key tile) sits in slot it % ITEMS, at
  // phase (it / ITEMS) % 2.
  auto slot = [&](int it) { return base + L::KV + (uint32_t)((it % ITEMS) * L::TILE_KV); };
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ITEMS; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full_bar + 8 * b, 1);
      mbar_init(q_empty_bar + 8 * b, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile its Q, then K(t) and V(t) for
    // each key tile.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;  // ring items loaded so far
      int wt = 0;  // work tiles so far
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++wt) {
        const int bh = w / qtiles;
        const int qb = wt & 1;
        const uint32_t q_bar = q_full_bar + 8 * qb;
        mbar_wait(q_empty_bar + 8 * qb, ((wt >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_bar, L::TILE_Q);
        for (int b = 0; b < F::NB; ++b)
          tma_load_3d(base + L::Q + qb * L::TILE_Q + b * FWD_BQ * F::ROW_BYTES, tm_q, q_bar,
                      b * F::CB, (w % qtiles) * FWD_BQ, bh);
        const int n = ntiles(w);
        for (int t = 0; t < 2 * n; ++t, ++it) {
          const int s = it % ITEMS;
          const uint32_t bar = full_bar + 8 * s;
          mbar_wait(empty_bar + 8 * s, ((it / ITEMS) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, L::TILE_KV);
          for (int b = 0; b < F::NB; ++b)
            tma_load_3d(slot(it) + b * BK * F::ROW_BYTES, (t & 1) ? tm_v : tm_k, bar, b * F::CB,
                        (t >> 1) * BK, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each work tile.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const float sl2 = scale * LOG2E;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int it = 0;
    int wt = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++wt) {
      const int bh = w / qtiles;
      const int row_first = (w % qtiles) * FWD_BQ + wg * 64;
      const int row0 = row_first + (tid >> 5) * 16 + (lane >> 2);  // and row0 + 8
      const int n = ntiles(w);
      const int qb = wt & 1;
      const uint32_t sQ = base + L::Q + qb * L::TILE_Q;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};

      mbar_wait(q_full_bar + 8 * qb, (wt >> 1) & 1);
      for (int t = 0; t < n; ++t, it += 2) {
        // S = Q K(t)^T (SS, both K-major).
        float sc[BK / 2];
        mbar_wait(full_bar + 8 * (it % ITEMS), (it / ITEMS) & 1);
        const uint32_t sK = slot(it);
        wgmma_fence();
        Wgmma<BK, T>::template ss_init<0>(sc, F::kmajor(sQ, FWD_BQ, wg * 64, 0),
                                          F::kmajor(sK, BK, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BK, T>::template ss<0>(sc, F::kmajor(sQ, FWD_BQ, wg * 64, kk),
                                       F::kmajor(sK, BK, 0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        release(empty_bar + 8 * (it % ITEMS));
        if (t == n - 1) release(q_empty_bar + 8 * qb);  // the last read of this Q

        float corr[2];
        uint32_t p[BK / 16][4];
        if (t * BK + BK > Sk || (causal && q_offset + row_first < k_offset + t * BK + BK - 1))
          softmax_tile<T, BK, true>(sc, m, l, corr, p, row0, t * BK, Sk, sl2, causal, q_offset,
                                    k_offset, tq);
        else
          softmax_tile<T, BK, false>(sc, m, l, corr, p, row0, t * BK, Sk, sl2, causal, q_offset,
                                     k_offset, tq);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

        // O += P V(t) (RS: P from registers, V MN-major).
        const int vt = it + 1;
        mbar_wait(full_bar + 8 * (vt % ITEMS), (vt / ITEMS) & 1);
        fence_regs(acc);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<D, T>::template rs<1>(acc, p[kk], F::mnmajor(slot(vt), BK, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_bar + 8 * (vt % ITEMS));
      }
      if (n == 0) release(q_empty_bar + 8 * qb);  // nothing visible: Q was never read

      // O / l in T straight from registers; lse directly.
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
      store_rows<T, D>(o + (size_t)bh * Sq * D, D, acc, inv, row0, Sq, tq);
    }
  }
}

// The forward's work at D = 16 to 128, called by flash_fwd_kernel<T, D>:
// per K/V stage S = Q K^T, the softmax, then O += P V; O leaves through
// tm_o. The producer runs ahead into the next work tile (its Q into the
// other buffer, its K/V tiles into the ring) while the consumers finish
// the current one.
template <typename T, int D>
__device__ __forceinline__ void flash_fwd_tiles(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                                const CUtensorMap* tm_v, const CUtensorMap* tm_o,
                                                float* __restrict__ lse, int BH, int Sq, int Sk,
                                                float scale, int causal, int q_offset,
                                                int k_offset) {
  using F = TileFormat<D>;
  using L = FwdSmem<D>;
  constexpr int BK = L::BK;
  constexpr int STAGES = L::STAGES;
  constexpr int QB = 2;  // Q buffers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BAR;                 // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * STAGES;        // stage s at + 8 s
  const uint32_t q_full_bar = empty_bar + 8 * STAGES;      // buffer b at + 8 b
  const uint32_t q_empty_bar = q_full_bar + 16;            // buffer b at + 8 b

  const int qtiles = (Sq + FWD_BQ - 1) / FWD_BQ;
  const int nwork = BH * qtiles;  // consecutive work tiles share a head's K/V in L2
  // K tiles that the rows of work tile w can see (causal tiles past them are skipped).
  auto ntiles = [&](int w) {
    return (key_end(Sk, (w % qtiles) * FWD_BQ, FWD_BQ, causal, q_offset, k_offset) + BK - 1) /
           BK;
  };
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full_bar + 8 * b, 1);
      mbar_init(q_empty_bar + 8 * b, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile its Q, then its K/V tiles.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int kt = 0;  // K/V tiles loaded so far: the ring position
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++it) {
        const int bh = w / qtiles;
        const int qb = it % QB;
        const uint32_t q_bar = q_full_bar + 8 * qb;
        mbar_wait(q_empty_bar + 8 * qb, ((it / QB) & 1) ^ 1);
        mbar_arrive_expect_tx(q_bar, L::TILE_Q);
        for (int b = 0; b < F::NB; ++b)
          tma_load_3d(base + L::Q + qb * L::TILE_Q + b * FWD_BQ * F::ROW_BYTES, tm_q, q_bar,
                      b * F::CB, (w % qtiles) * FWD_BQ, bh);
        const int n = ntiles(w);
        for (int t = 0; t < n; ++t, ++kt) {
          const int s = kt % STAGES;
          const uint32_t bar = full_bar + 8 * s;
          mbar_wait(empty_bar + 8 * s, ((kt / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, 2 * L::TILE_KV);
          const uint32_t sK = base + L::K + s * L::TILE_KV;
          const uint32_t sV = base + L::V + s * L::TILE_KV;
          for (int b = 0; b < F::NB; ++b) {
            tma_load_3d(sK + b * BK * F::ROW_BYTES, tm_k, bar, b * F::CB, t * BK, bh);
            tma_load_3d(sV + b * BK * F::ROW_BYTES, tm_v, bar, b * F::CB, t * BK, bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each work tile.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const float sl2 = scale * LOG2E;
    int kt = 0;
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++it) {
      const int bh = w / qtiles;
      const int row_first = (w % qtiles) * FWD_BQ + wg * 64;
      const int row0 = row_first + (tid >> 5) * 16 + (lane >> 2);  // and row0 + 8
      const int n = ntiles(w);
      const int qb = it % QB;
      const uint32_t sQ = base + L::Q + qb * L::TILE_Q;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};

      mbar_wait(q_full_bar + 8 * qb, (it / QB) & 1);
      for (int t = 0; t < n; ++t, ++kt) {
        const int s = kt % STAGES;
        const uint32_t sK = base + L::K + s * L::TILE_KV;
        const uint32_t sV = base + L::V + s * L::TILE_KV;
        mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);

        // S = Q K^T (SS, both K-major).
        float sc[BK / 2];
        wgmma_fence();
        Wgmma<BK, T>::template ss_init<0>(sc, F::kmajor(sQ, FWD_BQ, wg * 64, 0),
                                       F::kmajor(sK, BK, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BK, T>::template ss<0>(sc, F::kmajor(sQ, FWD_BQ, wg * 64, kk),
                                    F::kmajor(sK, BK, 0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (t == n - 1) {  // the last read of this Q
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty_bar + 8 * qb);
        }

        float corr[2];
        uint32_t p[BK / 16][4];
        if (t * BK + BK > Sk || (causal && q_offset + row_first < k_offset + t * BK + BK - 1))
          softmax_tile<T, BK, true>(sc, m, l, corr, p, row0, t * BK, Sk, sl2, causal, q_offset,
                                 k_offset, tq);
        else
          softmax_tile<T, BK, false>(sc, m, l, corr, p, row0, t * BK, Sk, sl2, causal, q_offset,
                                  k_offset, tq);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

        // O += P V (RS: P from registers, V MN-major).
        fence_regs(acc);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<D, T>::template rs<1>(acc, p[kk], F::mnmajor(sV, BK, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);
      }
      if (n == 0) {  // nothing visible: Q was never read
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty_bar + 8 * qb);
      }

      // O / l in T through the warpgroup's output tile and one TMA store
      // per box (rows past Sq are not written); the store runs on while the
      // next work tile starts. lse goes out directly.
      const uint32_t sO = base + L::O + wg * L::TILE_O;
      if (tid == 0) bulk_wait_read<0>();  // the last work tile's store has read sO
      named_sync(1 + wg, WG);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const bool empty = l[h] == 0.f;
        const float inv = empty ? 0.f : 1.f / l[h];
        const int r = row0 - row_first + 8 * h;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * h;
          st_shared_u32(sO + F::offset(64, r, 8 * j + 2 * tq),
                        pack2<T>(acc[i] * inv, acc[i + 1] * inv));
        }
        const int qi = row0 + 8 * h;
        if (tq == 0 && qi < Sq)
          lse[(size_t)bh * Sq + qi] = empty ? LSE_MASKED : m[h] * LN2 + logf(l[h]);
      }
      fence_async_smem();
      named_sync(1 + wg, WG);
      if (tid == 0) {
        for (int b = 0; b < F::NB; ++b)
          tma_store_3d(tm_o, sO + b * 64 * F::ROW_BYTES, b * F::CB, row_first, bh);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
  }
}

// Forward, persistent: a grid of one block per SM walks the work tiles
// (bh, 128 Q rows) in turn; o [BH, Sq, D] in T (written through tm_o, or at
// D = 256 through the pointer o), lse [BH, Sq] fp32.
template <typename T, int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 T* __restrict__ o, float* __restrict__ lse, int BH, int Sq, int Sk, float scale,
                 int causal, int q_offset, int k_offset) {
  if constexpr (D == 256)
    flash_fwd_256<T>(&tm_q, &tm_k, &tm_v, o, lse, BH, Sq, Sk, scale, causal, q_offset, k_offset);
  else
    flash_fwd_tiles<T, D>(&tm_q, &tm_k, &tm_v, &tm_o, lse, BH, Sq, Sk, scale, causal, q_offset,
                          k_offset);
}

constexpr int DQ_BQ = 128;  // Q rows of a dQ work tile

// Shared memory of dQ, byte offsets from a 1024-aligned base: the Q / dO
// buffers (two: the next work tile's Q and dO load while the current one
// runs), the K/V ring, and each consumer warpgroup's dQ tile on its way out
// by TMA. BK: K/V rows of a ring stage. Four stages, two at D = 128, where
// 32 KB stages share the 227 KB with 128 KB of Q / dO buffers and 32 KB of
// output tiles. At D = 256 one Q / dO buffer is 128 KB: one buffer, two
// 32-row K/V stages (64 KB), and dQ straight from registers (TMA_OUT
// false); the consumers hold dQ in 128 fp32 registers, S and dP in 16 each.
template <int D>
struct DqSmem {
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int STAGES = D >= 128 ? 2 : 4;
  static constexpr int Q_BUFS = D == 256 ? 1 : 2;
  static constexpr bool TMA_OUT = D != 256;
  static constexpr int TILE_Q = DQ_BQ * D * 2;
  static constexpr int TILE_KV = BK * D * 2;
  static constexpr int TILE_O = TMA_OUT ? 64 * D * 2 : 0;
  static constexpr int Q = 0;                          // + buffer * 2 * TILE_Q
  static constexpr int DO = Q + TILE_Q;                // + buffer * 2 * TILE_Q
  static constexpr int K = Q_BUFS * 2 * TILE_Q;        // + stage * 2 * TILE_KV
  static constexpr int V = K + TILE_KV;                // + stage * 2 * TILE_KV
  static constexpr int O = K + 2 * STAGES * TILE_KV;   // + warpgroup * TILE_O
  static constexpr int BAR = O + CONSUMER_WGS * TILE_O;  // full[S], empty[S], q_full[2], q_empty[2]
  static constexpr int BYTES = BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
};

// dS of one K/V tile on a consumer thread's registers (rows row0 and
// row0 + 8, keys k0 + c): P = exp2(S scale log2(e) - lse2[h]), dS =
// P (dP + gd[h]), as the bf16 A fragments of dQ += dS K. lse2 is lse
// log2(e), gd is g_lse - delta. MASK: the tile holds keys past Sk (zero
// rows of K, but their P need not be finite) or causally hidden keys for
// some of those rows.
template <typename T, int BK, bool MASK>
__device__ __forceinline__ void dq_dscores(const float (&st)[BK / 2], const float (&dp)[BK / 2],
                                           const float (&lse2)[2], const float (&gd)[2],
                                           uint32_t (&dsf)[BK / 16][4], int row0, int k0, int Sk,
                                           float sl2, int causal, int q_offset, int k_offset,
                                           int tq) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r, h = r & 1;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = exp2f(fmaf(st[i + e], sl2, -lse2[h]));
        if (MASK) {
          const int kj = k0 + 8 * (i >> 2) + 2 * tq + e;
          if (kj >= Sk || (causal && q_offset + row0 + 8 * h < k_offset + kj)) p = 0.f;
        }
        ds[e] = p * (dp[i + e] + gd[h]);
      }
      dsf[kk][r] = pack2<T>(ds[0], ds[1]);
    }
}

// dQ, persistent: a grid of one block per SM walks the work tiles (bh,
// 128 Q rows) in turn and loops over the K/V tiles their rows can see.
// dQ = scale * sum_j dS_ij K_j, written through tm_dq, or at D = 256
// through the pointer dq_out.
template <typename T, int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_dq, T* __restrict__ dq_out,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ glse, int BH, int Sq, int Sk, float scale, int causal,
                int q_offset, int k_offset) {
  using F = TileFormat<D>;
  using L = DqSmem<D>;
  constexpr int BK = L::BK;
  constexpr int QB = L::Q_BUFS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BAR;                 // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * L::STAGES;     // stage s at + 8 s
  const uint32_t q_full_bar = empty_bar + 8 * L::STAGES;   // buffer b at + 8 b
  const uint32_t q_empty_bar = q_full_bar + 16;            // buffer b at + 8 b

  const int qtiles = (Sq + DQ_BQ - 1) / DQ_BQ;
  const int nwork = BH * qtiles;  // consecutive work tiles share a head's K/V in L2
  // K/V tiles that the rows of work tile w can see (causal tiles past them are skipped).
  auto ntiles = [&](int w) {
    return (key_end(Sk, (w % qtiles) * DQ_BQ, DQ_BQ, causal, q_offset, k_offset) + BK - 1) / BK;
  };
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full_bar + 8 * b, 1);
      mbar_init(q_empty_bar + 8 * b, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile its Q and dO, then its K/V tiles.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int kt = 0;  // K/V tiles loaded so far: the ring position
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++it) {
        const int bh = w / qtiles;
        const int q0 = (w % qtiles) * DQ_BQ;
        const int qb = it % QB;
        const uint32_t q_bar = q_full_bar + 8 * qb;
        const uint32_t sQ = base + L::Q + qb * 2 * L::TILE_Q;
        const uint32_t sdO = base + L::DO + qb * 2 * L::TILE_Q;
        mbar_wait(q_empty_bar + 8 * qb, ((it / QB) & 1) ^ 1);
        mbar_arrive_expect_tx(q_bar, 2 * L::TILE_Q);
        for (int b = 0; b < F::NB; ++b) {
          tma_load_3d(sQ + b * DQ_BQ * F::ROW_BYTES, &tm_q, q_bar, b * F::CB, q0, bh);
          tma_load_3d(sdO + b * DQ_BQ * F::ROW_BYTES, &tm_do, q_bar, b * F::CB, q0, bh);
        }
        const int n = ntiles(w);
        for (int t = 0; t < n; ++t, ++kt) {
          const int s = kt % L::STAGES;
          const uint32_t bar = full_bar + 8 * s;
          mbar_wait(empty_bar + 8 * s, ((kt / L::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, 2 * L::TILE_KV);
          const uint32_t sK = base + L::K + s * 2 * L::TILE_KV;
          const uint32_t sV = base + L::V + s * 2 * L::TILE_KV;
          for (int b = 0; b < F::NB; ++b) {
            tma_load_3d(sK + b * BK * F::ROW_BYTES, &tm_k, bar, b * F::CB, t * BK, bh);
            tma_load_3d(sV + b * BK * F::ROW_BYTES, &tm_v, bar, b * F::CB, t * BK, bh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each work tile.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    // lse log2(e) and g_lse - delta of this thread's two rows of work tile
    // w; rows past Sq get lse2 = LSE_MASKED, so their P is exactly 0.
    auto fetch_rows = [&](int w, float (&lse2)[2], float (&gd)[2]) {
      const int bh = w / qtiles;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = (w % qtiles) * DQ_BQ + wg * 64 + r + 8 * h;
        const size_t at = (size_t)bh * Sq + qi;
        lse2[h] = qi < Sq ? lse[at] * LOG2E : LSE_MASKED;
        gd[h] = qi < Sq ? glse[at] - delta[at] : 0.f;
      }
    };
    float lse2_next[2] = {LSE_MASKED, LSE_MASKED}, gd_next[2] = {0.f, 0.f};
    if ((int)blockIdx.x < nwork) fetch_rows(blockIdx.x, lse2_next, gd_next);
    int kt = 0;
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++it) {
      const int bh = w / qtiles;
      const int row_first = (w % qtiles) * DQ_BQ + wg * 64;
      const int row0 = row_first + r;  // and row0 + 8
      const int n = ntiles(w);
      const int qb = it % QB;
      const uint32_t sQ = base + L::Q + qb * 2 * L::TILE_Q;
      const uint32_t sdO = base + L::DO + qb * 2 * L::TILE_Q;
      // The rows of this work tile, and the next one's on their way.
      const float lse2[2] = {lse2_next[0], lse2_next[1]};
      const float gd[2] = {gd_next[0], gd_next[1]};
      if (w + (int)gridDim.x < nwork) fetch_rows(w + gridDim.x, lse2_next, gd_next);
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      mbar_wait(q_full_bar + 8 * qb, (it / QB) & 1);
      for (int t = 0; t < n; ++t, ++kt) {
        const int s = kt % L::STAGES;
        const uint32_t sK = base + L::K + s * 2 * L::TILE_KV;
        const uint32_t sV = base + L::V + s * 2 * L::TILE_KV;
        mbar_wait(full_bar + 8 * s, (kt / L::STAGES) & 1);

        // S = Q K^T and dP = dO V^T (SS, all K-major).
        float st[BK / 2], dp[BK / 2];
        wgmma_fence();
        Wgmma<BK, T>::template ss_init<0>(st, F::kmajor(sQ, DQ_BQ, wg * 64, 0),
                                       F::kmajor(sK, BK, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BK, T>::template ss<0>(st, F::kmajor(sQ, DQ_BQ, wg * 64, kk),
                                    F::kmajor(sK, BK, 0, kk));
        Wgmma<BK, T>::template ss_init<0>(dp, F::kmajor(sdO, DQ_BQ, wg * 64, 0),
                                       F::kmajor(sV, BK, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BK, T>::template ss<0>(dp, F::kmajor(sdO, DQ_BQ, wg * 64, kk),
                                    F::kmajor(sV, BK, 0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);
        if (t == n - 1) {  // the last read of this Q and dO
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty_bar + 8 * qb);
        }

        uint32_t dsf[BK / 16][4];
        if (t * BK + BK > Sk || (causal && q_offset + row_first < k_offset + t * BK + BK - 1))
          dq_dscores<T, BK, true>(st, dp, lse2, gd, dsf, row0, t * BK, Sk, sl2, causal, q_offset,
                               k_offset, tq);
        else
          dq_dscores<T, BK, false>(st, dp, lse2, gd, dsf, row0, t * BK, Sk, sl2, causal, q_offset,
                                k_offset, tq);

        // dQ += dS K (RS: dS from registers, K MN-major).
        fence_regs(dq);
        fence_regs(dsf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<D, T>::template rs<1>(dq, dsf[kk], F::mnmajor(sK, BK, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);
      }
      if (n == 0) {  // no key visible: Q and dO were never read, and dQ is 0
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty_bar + 8 * qb);
      }

      const float mul[2] = {scale, scale};
      if constexpr (L::TMA_OUT)
        store_out<T, D>(&tm_dq, base + L::O + wg * L::TILE_O, dq, mul, r, tq, tid, wg, row_first,
                        bh);
      else
        store_rows<T, D>(dq_out + (size_t)bh * Sq * D, D, dq, mul, row0, Sq, tq);
    }
    if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
  }
}

constexpr int DKV_BK = 128;  // keys of a dK/dV work tile

// Shared memory of dK/dV, byte offsets from a 1024-aligned base: the K/V
// buffers (two: the next work tile's K and V load while the current one
// runs), the ring of Q / dO tiles with their row vectors, and each consumer
// warpgroup's dK and dV tiles on their way out by TMA. BQ: Q rows of a ring
// stage; at D = 128 the 64 + 64 floats of dK and dV per thread leave
// registers for a 32-row stage only, and shared memory for two stages.
// OW: the output columns of a work tile. At D = 256, dK and dV of all 256
// columns would take 128 + 128 fp32 registers per thread, which do not
// fit: a work tile computes OW = 128 columns of each (64 + 64 registers, as
// at D = 128), and the two halves of D are two work tiles that each
// recompute S^T and dP^T over all of D (1.5x the operations of one pass).
// There one K/V buffer is 128 KB: one buffer, two 32-row stages (64 KB),
// and dK, dV straight from registers (TMA_OUT false).
template <int D>
struct DkvSmem {
  static constexpr int OW = D == 256 ? 128 : D;
  static constexpr int HALVES = D / OW;
  static constexpr int BQ = D >= 128 ? 32 : 64;
  static constexpr int STAGES = D >= 128 ? 2 : 4;
  static constexpr int KV_BUFS = D == 256 ? 1 : 2;
  static constexpr bool TMA_OUT = D != 256;
  static constexpr int TILE_KV = DKV_BK * D * 2;
  static constexpr int TILE_Q = BQ * D * 2;
  static constexpr int TILE_O = TMA_OUT ? 64 * D * 2 : 0;
  static constexpr int ROWS = 2 * BQ * 4;  // lse * log2(e), then g_lse - delta
  static constexpr int K = 0;                        // + buffer * 2 * TILE_KV
  static constexpr int V = K + TILE_KV;              // + buffer * 2 * TILE_KV
  static constexpr int Q = KV_BUFS * 2 * TILE_KV;    // + stage * TILE_Q
  static constexpr int DO = Q + STAGES * TILE_Q;     // + stage * TILE_Q
  static constexpr int OUT = DO + STAGES * TILE_Q;   // dK, dV of warpgroup w at + 2 w TILE_O
  static constexpr int ROW = OUT + 4 * TILE_O;       // + stage * ROWS
  static constexpr int BAR = ROW + STAGES * ROWS;    // full[S], empty[S], kv_full[2], kv_empty[2]
  static constexpr int BYTES = BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
};

// P^T and dS^T of one Q tile on a consumer thread's registers (keys key0 and
// key0 + 8, Q columns q0 + c): P^T = exp(S^T scale - lse[c]), dS^T =
// P^T (dP^T + g_lse[c] - delta[c]), in place and as bf16 A fragments.
template <typename T, int BQ, bool MASK>
__device__ __forceinline__ void dkv_probs(float (&st)[BQ / 2], float (&dpt)[BQ / 2],
                                          const float* rows, uint32_t (&pf)[BQ / 16][4],
                                          uint32_t (&dsf)[BQ / 16][4], int key0, int q0,
                                          float sl2, int q_offset, int k_offset, int tq) {
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) {
    const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
    float pv = exp2f(fmaf(st[i], sl2, -rows[c]));
    if (MASK && q_offset + q0 + c < k_offset + key0 + 8 * ((i >> 1) & 1)) pv = 0.f;
    st[i] = pv;
    dpt[i] = pv * (dpt[i] + rows[BQ + c]);
  }
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pf[kk][r] = pack2<T>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
      dsf[kk][r] = pack2<T>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
    }
}

// dK/dV, persistent: a grid of one block per SM walks the work tiles (bh,
// 128 keys, half of D at D = 256) in turn and loops over the Q tiles that
// can see them. dV = sum_i P_ij^T dO_i; dK = scale * sum_i dS_ij^T Q_i,
// written through tm_dk and tm_dv, or at D = 256 through the pointers
// dk_out and dv_out.
template <typename T, int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dk,
                 const __grid_constant__ CUtensorMap tm_dv, T* __restrict__ dk_out,
                 T* __restrict__ dv_out, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ glse, int BH, int Sq,
                 int Sk, float scale, int causal, int q_offset, int k_offset) {
  using F = TileFormat<D>;
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ;
  constexpr int OW = L::OW;
  constexpr int KB = L::KV_BUFS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // the same base, generic
  const uint32_t full_bar = base + L::BAR;                  // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * L::STAGES;     // stage s at + 8 s
  const uint32_t kv_full_bar = empty_bar + 8 * L::STAGES;  // buffer b at + 8 b
  const uint32_t kv_empty_bar = kv_full_bar + 16;           // buffer b at + 8 b

  const int ktiles = (Sk + DKV_BK - 1) / DKV_BK;
  // Work tile w: head w / (ktiles HALVES), key tile (w / HALVES) % ktiles,
  // columns half w % HALVES. Consecutive work tiles share a head's Q and dO
  // in L2 (at D = 256 the two halves of one key tile are neighbours).
  const int nwork = BH * ktiles * L::HALVES;
  auto key_tile = [&](int w) { return (w / L::HALVES) % ktiles; };
  // The first Q tile that can see work tile w's keys, and the number of Q tiles.
  auto qbegin = [&](int w) {
    return query_begin(key_tile(w) * DKV_BK, BQ, causal, q_offset, k_offset);
  };
  auto ntiles = [&](int w) {
    const int q0 = qbegin(w);
    return q0 < Sq ? (Sq - q0 + BQ - 1) / BQ : 0;
  };
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 32);  // the producer warp's lanes (row vectors, then TMA)
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(kv_full_bar + 8 * b, 1);
      mbar_init(kv_empty_bar + 8 * b, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, first warp: per work tile its K and V, then the ring of Q /
    // dO tiles and their row vectors.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 == CONSUMER_WGS * 4) {
      const int lane = threadIdx.x & 31;
      int qt = 0;  // Q tiles loaded so far: the ring position
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++it) {
        const int bh = w / (ktiles * L::HALVES);
        const int kb = it % KB;
        mbar_wait(kv_empty_bar + 8 * kb, ((it / KB) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t bar = kv_full_bar + 8 * kb;
          const uint32_t sK = base + L::K + kb * 2 * L::TILE_KV;
          const uint32_t sV = base + L::V + kb * 2 * L::TILE_KV;
          const int k0 = key_tile(w) * DKV_BK;
          mbar_arrive_expect_tx(bar, 2 * L::TILE_KV);
          for (int b = 0; b < F::NB; ++b) {
            tma_load_3d(sK + b * DKV_BK * F::ROW_BYTES, &tm_k, bar, b * F::CB, k0, bh);
            tma_load_3d(sV + b * DKV_BK * F::ROW_BYTES, &tm_v, bar, b * F::CB, k0, bh);
          }
        }
        const float* lse_b = lse + (size_t)bh * Sq;
        const float* delta_b = delta + (size_t)bh * Sq;
        const float* glse_b = glse + (size_t)bh * Sq;
        const int n = ntiles(w);
        for (int t = 0; t < n; ++t, ++qt) {
          const int s = qt % L::STAGES;
          const int q0 = qbegin(w) + t * BQ;
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
    // Consumer warpgroup wg: keys [64 wg, 64 wg + 64) of each work tile.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const float sl2 = scale * LOG2E;
    int qt = 0;
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++it) {
      const int bh = w / (ktiles * L::HALVES);
      const int half = w % L::HALVES;  // output columns [half OW, half OW + OW)
      const int key_first = key_tile(w) * DKV_BK + wg * 64;
      const int key0 = key_first + (tid >> 5) * 16 + (lane >> 2);  // and key0 + 8
      const int n = ntiles(w);
      const int kb = it % KB;
      const uint32_t sK = base + L::K + kb * 2 * L::TILE_KV;
      const uint32_t sV = base + L::V + kb * 2 * L::TILE_KV;
      float dk_acc[OW / 2], dv_acc[OW / 2];
#pragma unroll
      for (int i = 0; i < OW / 2; ++i) {
        dk_acc[i] = 0.f;
        dv_acc[i] = 0.f;
      }

      mbar_wait(kv_full_bar + 8 * kb, (it / KB) & 1);
      for (int t = 0; t < n; ++t, ++qt) {
        const int s = qt % L::STAGES;
        const int q0 = qbegin(w) + t * BQ;
        const uint32_t sQ = base + L::Q + s * L::TILE_Q;
        const uint32_t sdO = base + L::DO + s * L::TILE_Q;
        mbar_wait(full_bar + 8 * s, (qt / L::STAGES) & 1);

        // S^T = K Q^T and dP^T = V dO^T (SS, all K-major).
        float st[BQ / 2], dpt[BQ / 2];
        wgmma_fence();
        Wgmma<BQ, T>::template ss_init<0>(st, F::kmajor(sK, DKV_BK, wg * 64, 0),
                                       F::kmajor(sQ, BQ, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BQ, T>::template ss<0>(st, F::kmajor(sK, DKV_BK, wg * 64, kk),
                                    F::kmajor(sQ, BQ, 0, kk));
        Wgmma<BQ, T>::template ss_init<0>(dpt, F::kmajor(sV, DKV_BK, wg * 64, 0),
                                       F::kmajor(sdO, BQ, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          Wgmma<BQ, T>::template ss<0>(dpt, F::kmajor(sV, DKV_BK, wg * 64, kk),
                                    F::kmajor(sdO, BQ, 0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (t == n - 1) {  // the last read of this K and V
          __syncwarp();
          if (lane == 0) mbar_arrive(kv_empty_bar + 8 * kb);
        }

        const float* rows = reinterpret_cast<const float*>(smem + L::ROW + s * L::ROWS);
        uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
        if (causal && q_offset + q0 < k_offset + key_first + 63)
          dkv_probs<T, BQ, true>(st, dpt, rows, pf, dsf, key0, q0, sl2, q_offset, k_offset, tq);
        else
          dkv_probs<T, BQ, false>(st, dpt, rows, pf, dsf, key0, q0, sl2, q_offset, k_offset, tq);

        // dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major), over the
        // work tile's output columns.
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pf);
        fence_regs(dsf);
        wgmma_fence();
        const int box0 = half * OW / F::CB;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<OW, T>::template rs<1>(dv_acc, pf[kk], F::mnmajor(sdO, BQ, kk, box0));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<OW, T>::template rs<1>(dk_acc, dsf[kk], F::mnmajor(sQ, BQ, kk, box0));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);
      }
      if (n == 0) {  // no Q row sees these keys: K and V were never read
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty_bar + 8 * kb);
      }

      // dK and dV in T through the warpgroup's output tiles and TMA
      // stores, which run on while the next work tile starts, or at D = 256
      // straight from registers. Keys past Sk are not written (so they
      // needed no mask above).
      if constexpr (L::TMA_OUT) {
        const uint32_t sdK = base + L::OUT + 2 * wg * L::TILE_O;
        const uint32_t sdV = sdK + L::TILE_O;
        if (tid == 0) bulk_wait_read<0>();  // the last work tile's stores have read them
        named_sync(1 + wg, WG);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = key0 - key_first + 8 * h;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int i = 4 * j + 2 * h;
            const uint32_t at = F::offset(64, r, 8 * j + 2 * tq);
            st_shared_u32(sdK + at, pack2<T>(scale * dk_acc[i], scale * dk_acc[i + 1]));
            st_shared_u32(sdV + at, pack2<T>(dv_acc[i], dv_acc[i + 1]));
          }
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
      } else {
        const size_t at = (size_t)bh * Sk * D + half * OW;
        const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
        store_rows<T, OW>(dk_out + at, D, dk_acc, mul_k, key0, Sk, tq);
        store_rows<T, OW>(dv_out + at, D, dv_acc, mul_v, key0, Sk, tq);
      }
    }
    if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
  }
}

// ===========================================================================
// Launchers.
// ===========================================================================

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
               int Sk, float scale, int causal, int qo, int ko, cudaStream_t stream) {
  if (!BH || !Sq || !Sk)
    return fwd_empty(o, (size_t)BH * Sq * D * sizeof(T), lse, (long long)BH * Sq, stream);
  if constexpr (!std::is_same<T, float>::value) {
    CUtensorMap mq, mk, mv, mo;
    int err;
    if ((err = make_tile_map<T, D>(&mq, q, Sq, BH, FWD_BQ)) ||
        (err = make_tile_map<T, D>(&mk, k, Sk, BH, FwdSmem<D>::BK)) ||
        (err = make_tile_map<T, D>(&mv, v, Sk, BH, FwdSmem<D>::BK)) ||
        (err = make_tile_map<T, D>(&mo, o, Sq, BH, 64)))
      return err;
    const int nwork = BH * ((Sq + FWD_BQ - 1) / FWD_BQ);
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    return launch(flash_fwd_kernel<T, D>, dim3(nwork < sms ? nwork : sms), SM90_THREADS,
                  FwdSmem<D>::BYTES, stream, mq, mk, mv, mo, (T*)o, (float*)lse, BH, Sq, Sk,
                  scale, causal, qo, ko);
  } else {
    return launch_fwd_3xtf32(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, qo, ko, stream);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* glse, void* dq, int BH, int Sq, int Sk,
              float scale, int causal, int qo, int ko, cudaStream_t stream) {
  if (!BH || !Sq || !Sk) return zero_fill(stream, (size_t)BH * Sq * D * sizeof(T), dq);
  if constexpr (!std::is_same<T, float>::value) {
    CUtensorMap mq, mk, mv, mdo, mdq;
    int err;
    if ((err = make_tile_map<T, D>(&mq, q, Sq, BH, DQ_BQ)) ||
        (err = make_tile_map<T, D>(&mk, k, Sk, BH, DqSmem<D>::BK)) ||
        (err = make_tile_map<T, D>(&mv, v, Sk, BH, DqSmem<D>::BK)) ||
        (err = make_tile_map<T, D>(&mdo, dout, Sq, BH, DQ_BQ)) ||
        (err = make_tile_map<T, D>(&mdq, dq, Sq, BH, 64)))
      return err;
    const int nwork = BH * ((Sq + DQ_BQ - 1) / DQ_BQ);
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    return launch(flash_dq_kernel<T, D>, dim3(nwork < sms ? nwork : sms), SM90_THREADS,
                  DqSmem<D>::BYTES, stream, mq, mk, mv, mdo, mdq, (T*)dq, (const float*)lse,
                  (const float*)delta, (const float*)glse, BH, Sq, Sk, scale, causal, qo, ko);
  } else {
    return launch_dq_3xtf32(q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, D, scale, causal, qo,
                            ko, stream);
  }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* glse, void* dk, void* dv, int BH, int Sq, int Sk,
               float scale, int causal, int qo, int ko, cudaStream_t stream) {
  if (!BH || !Sq || !Sk) return zero_fill(stream, (size_t)BH * Sk * D * sizeof(T), dk, dv);
  if constexpr (!std::is_same<T, float>::value) {
    constexpr int bq = DkvSmem<D>::BQ;
    CUtensorMap mq, mk, mv, mdo, mdk, mdv;
    int err;
    if ((err = make_tile_map<T, D>(&mq, q, Sq, BH, bq)) ||
        (err = make_tile_map<T, D>(&mk, k, Sk, BH, DKV_BK)) ||
        (err = make_tile_map<T, D>(&mv, v, Sk, BH, DKV_BK)) ||
        (err = make_tile_map<T, D>(&mdo, dout, Sq, BH, bq)) ||
        (err = make_tile_map<T, D>(&mdk, dk, Sk, BH, 64)) ||
        (err = make_tile_map<T, D>(&mdv, dv, Sk, BH, 64)))
      return err;
    const int nwork = BH * ((Sk + DKV_BK - 1) / DKV_BK) * DkvSmem<D>::HALVES;
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    return launch(flash_dkv_kernel<T, D>, dim3(nwork < sms ? nwork : sms), SM90_THREADS,
                  DkvSmem<D>::BYTES, stream, mq, mk, mv, mdo, mdk, mdv, (T*)dk, (T*)dv,
                  (const float*)lse, (const float*)delta, (const float*)glse, BH, Sq, Sk, scale,
                  causal, qo, ko);
  } else {
    return launch_dkv_3xtf32(q, k, v, dout, lse, delta, glse, dk, dv, BH, Sq, Sk, D, scale,
                             causal, qo, ko, stream);
  }
}

// The fill kernel of fill_lse_masked.
__global__ void flash_fwd_no_key_kernel(float* __restrict__ lse, long long rows) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < rows;
       i += (long long)gridDim.x * blockDim.x)
    lse[i] = LSE_MASKED;
}

}  // namespace

int fill_lse_masked(float* lse, long long rows, cudaStream_t stream) {
  const long long blocks = (rows + 255) / 256;
  flash_fwd_no_key_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(lse,
                                                                                     rows);
  return cudaGetLastError();
}

extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                  int Sq, int Sk, int D, int dtype, int causal, int q_offset, int k_offset,
                  float scale, void* stream) {
  HVD_DISPATCH_WIDE(dtype, D,
                    (launch_fwd<T, HD>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, q_offset,
                                  k_offset, (cudaStream_t)stream)));
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* glse, void* dq, int BH, int Sq,
                 int Sk, int D, int dtype, int causal, int q_offset, int k_offset, float scale,
                 void* stream) {
  HVD_DISPATCH_WIDE(dtype, D,
                    (launch_dq<T, HD>(q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, scale,
                                 causal, q_offset, k_offset, (cudaStream_t)stream)));
}

int hvd_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                  int BH, int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                  int k_offset, float scale, void* stream) {
  HVD_DISPATCH_WIDE(dtype, D,
                    (launch_dkv<T, HD>(q, k, v, dout, lse, delta, glse, dk, dv, BH, Sq, Sk, scale,
                                  causal, q_offset, k_offset, (cudaStream_t)stream)));
}

// The message of any entry point's error code, for every source of the
// library (horovod_tpu_torch/ops/_kernels.py raises it).
const char* hvd_error_string(int err) {
  if (err >= HVD_ERR_TENSOR_MAP) {
    static thread_local char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - HVD_ERR_TENSOR_MAP);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
