// Flash attention for Hopper (sm_90a): the multi-tile forward, dQ and dK/dV
// kernels. horovod_tpu_torch/ops/attention.py routes here when Sq or Sk is
// above SINGLE_TILE_MAX (128 rows); shorter sequences go to the single-tile
// kernels of flash_attention_single.cu.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/attention.py:
//   flash_fwd_kernel  <- _flash_fwd_kernel (:138)
//   flash_dq_kernel   <- _flash_dq_kernel (:198)
//   flash_dkv_kernel  <- _flash_dkv_kernel (:252)
//
// What bounds them, against the H100 SXM data-sheet peaks (989 TFLOP/s bf16,
// 3.35 TB/s, at its 700 W limit): at the BERT-Large S = 512 shape
// (B*H = 128, D = 64, bf16) the forward does 8.59 GFLOP over 33.8 MB, about
// 254 FLOP per byte, below the card's ridge point (~295 FLOP per byte), so it
// is bound by bytes; dQ (12.88 GFLOP over 42.7 MB) and dK/dV (17.18 GFLOP
// over 51.1 MB) sit above the ridge and are bound by tensor-core operations.
// The score matrix is S^2 per head and is the one thing that must never reach
// device memory.
//
// What the design does about it: the TPU's sequential grid axis becomes a
// loop inside one thread block. A block owns a 64-row tile (a Q tile for the
// forward and dQ kernels, a K/V tile for the dK/dV kernel), keeps its fp32
// accumulators in shared memory, and streams the other operand through shared
// memory 64 rows at a time, so scores and probabilities live only in shared
// memory. The dQ / dK-dV split of the TPU version is kept: each output tile
// has exactly one owner block, so no atomics are needed. Products take the
// stored dtype (bf16 on tensor cores through WMMA 16x16x16 fragments, fp32
// accumulation; float32 on the FMA units), and P and dS are rounded to the
// operand dtype before the PV, P^T dO, dS K and dS^T Q products, as the TPU
// kernels do. This is the simple first version: no TMA, no wgmma, no
// pipelining of loads against compute.
//
// Semantics (identical to the TPU kernels): causal masking on global
// positions q_offset + i >= k_offset + j; a row with no visible key gives
// O = 0 and lse = 1e30; the backward takes the cotangent of lse (g_lse) into
// dS = P * (dO V^T - delta + g_lse). Rows and keys past the sequence end are
// masked, so any sequence length works.
//
// C interface: every entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // rows of a Q tile
constexpr int BK = 64;  // rows of a K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WROWS = 16;  // rows owned by one warp (NWARPS * WROWS == 64)

static_assert(NWARPS * WROWS == BQ && BQ == BK, "one 16-row slice per warp");

// Leading dimensions in shared memory, padded by 32 bytes: every WMMA
// fragment pointer stays 256-bit aligned and rows fall on different banks.
template <typename T, int D>
struct Layout {
  static constexpr int LDT = D + 32 / (int)sizeof(T);   // operand tiles
  static constexpr int LDS = BK + 8;                     // fp32 scores
  static constexpr int LDP = BK + 32 / (int)sizeof(T);   // P / dS in T
  static constexpr int LDO = D + 8;                      // fp32 accumulators
};

// Key rows [0, kend) can be visible to Q rows [q0, q0 + 64).
__device__ __forceinline__ int key_end(int Sk, int q0, int causal, int q_offset, int k_offset) {
  if (!causal) return Sk;
  const int last = q_offset - k_offset + q0 + BQ;  // one past the last visible key
  return last < Sk ? (last > 0 ? last : 0) : Sk;
}

// First Q tile start whose rows can see key rows [k0, k0 + 64).
__device__ __forceinline__ int query_begin(int k0, int causal, int q_offset, int k_offset) {
  if (!causal) return 0;
  const int first = k_offset + k0 - q_offset;
  return first > 0 ? (first / BQ) * BQ : 0;
}

// ---------------------------------------------------------------------------
// Forward: one block per (bh, Q tile); loop over K/V tiles with an online
// softmax. o [BH, Sq, D], lse [BH, Sq] fp32.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, float scale,
                 int causal, int q_offset, int k_offset) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * L::LDT;
  T* sV = sK + BK * L::LDT;
  float* sS = reinterpret_cast<float*>(sV + BK * L::LDT);
  T* sP = reinterpret_cast<T*>(sS + BQ * L::LDS);
  float* sO = reinterpret_cast<float*>(sP + BQ * L::LDP);
  float* sM = sO + BQ * L::LDO;
  float* sL = sM + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * WROWS;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  load_tile<T, D, BQ, NTHREADS>(sQ, L::LDT, qb, q0, Sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  const int kend = key_end(Sk, q0, causal, q_offset, k_offset);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K, V and P
    load_tile<T, D, BK, NTHREADS>(sK, L::LDT, kb, k0, Sk);
    load_tile<T, D, BK, NTHREADS>(sV, L::LDT, vb, k0, Sk);
    __syncthreads();

    warp_gemm<false, true, BK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT, sS + r0 * L::LDS,
                                  L::LDS, false);
    __syncwarp();
    for (int r = r0; r < r0 + WROWS; ++r) {
      const int qi = q0 + r;
      const bool ok0 = visible(qi, k0 + lane, Sq, Sk, causal, q_offset, k_offset);
      const bool ok1 = visible(qi, k0 + lane + 32, Sq, Sk, causal, q_offset, k_offset);
      const float s0 = ok0 ? sS[r * L::LDS + lane] * scale : NEG_INF;
      const float s1 = ok1 ? sS[r * L::LDS + lane + 32] * scale : NEG_INF;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float corr = expf(m_prev - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      sP[r * L::LDP + lane] = from_f<T>(p0);
      sP[r * L::LDP + lane + 32] = from_f<T>(p1);
      for (int c = lane; c < D; c += 32) sO[r * L::LDO + c] *= corr;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + psum;
      }
    }
    __syncwarp();
    warp_gemm<false, false, D, BK>(sP + r0 * L::LDP, L::LDP, sV, L::LDT, sO + r0 * L::LDO,
                                   L::LDO, true);
  }
  __syncthreads();

  T* ob = o + (size_t)bh * Sq * D;
  for (int r = r0; r < r0 + WROWS; ++r) {
    const int qi = q0 + r;
    if (qi >= Sq) break;
    const float l = sL[r];
    const bool empty = l == 0.f;
    const float safe_l = empty ? 1.f : l;
    for (int c = lane; c < D; c += 32) ob[(size_t)qi * D + c] = from_f<T>(sO[r * L::LDO + c] / safe_l);
    if (lane == 0) lse[(size_t)bh * Sq + qi] = empty ? LSE_MASKED : sM[r] + logf(safe_l);
  }
}

// P and dS for one warp's 16 rows of a (Q tile, K tile) pair, written to
// shared memory in the operand dtype. Rows index Q, columns index K.
template <typename T, int LDS, int LDP>
__device__ __forceinline__ void probs_and_dscores(
    const float* sS, const float* sdP, const float* sLse, const float* sDelta,
    const float* sGlse, T* sP, T* sdS, int r0, int q0, int k0, int Sq, int Sk, float scale,
    int causal, int q_offset, int k_offset) {
  const int lane = threadIdx.x & 31;
  for (int r = r0; r < r0 + WROWS; ++r) {
    const int qi = q0 + r;
    const float lse_r = sLse[r];
    const float g_r = sGlse[r] - sDelta[r];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const bool ok = visible(qi, k0 + c, Sq, Sk, causal, q_offset, k_offset);
      const float p = ok ? expf(sS[r * LDS + c] * scale - lse_r) : 0.f;
      const float ds = p * (sdP[r * LDS + c] + g_r);
      if (sP != nullptr) sP[r * LDP + c] = from_f<T>(p);
      sdS[r * LDP + c] = from_f<T>(ds);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (bh, Q tile); loop over K/V tiles.
// dQ = scale * sum_j dS_ij K_j.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const float* __restrict__ glse,
                T* __restrict__ dq, int Sq, int Sk, float scale, int causal, int q_offset,
                int k_offset) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BQ * L::LDT;
  T* sK = sdO + BQ * L::LDT;
  T* sV = sK + BK * L::LDT;
  float* sS = reinterpret_cast<float*>(sV + BK * L::LDT);
  float* sdP = sS + BQ * L::LDS;
  T* sdS = reinterpret_cast<T*>(sdP + BQ * L::LDS);
  float* sdQ = reinterpret_cast<float*>(sdS + BQ * L::LDP);
  float* sLse = sdQ + BQ * L::LDO;
  float* sDelta = sLse + BQ;
  float* sGlse = sDelta + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * WROWS;
  const size_t qoff = (size_t)bh * Sq * D;
  const size_t koff = (size_t)bh * Sk * D;

  load_tile<T, D, BQ, NTHREADS>(sQ, L::LDT, q + qoff, q0, Sq);
  load_tile<T, D, BQ, NTHREADS>(sdO, L::LDT, dout + qoff, q0, Sq);
  load_rows<BQ, NTHREADS>(sLse, lse + (size_t)bh * Sq, q0, Sq);
  load_rows<BQ, NTHREADS>(sDelta, delta + (size_t)bh * Sq, q0, Sq);
  load_rows<BQ, NTHREADS>(sGlse, glse + (size_t)bh * Sq, q0, Sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sdQ[i] = 0.f;
  const int kend = key_end(Sk, q0, causal, q_offset, k_offset);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tile<T, D, BK, NTHREADS>(sK, L::LDT, k + koff, k0, Sk);
    load_tile<T, D, BK, NTHREADS>(sV, L::LDT, v + koff, k0, Sk);
    __syncthreads();

    warp_gemm<false, true, BK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT, sS + r0 * L::LDS,
                                  L::LDS, false);
    warp_gemm<false, true, BK, D>(sdO + r0 * L::LDT, L::LDT, sV, L::LDT, sdP + r0 * L::LDS,
                                  L::LDS, false);
    __syncwarp();
    probs_and_dscores<T, L::LDS, L::LDP>(sS, sdP, sLse, sDelta, sGlse, nullptr, sdS, r0, q0,
                                         k0, Sq, Sk, scale, causal, q_offset, k_offset);
    __syncwarp();
    warp_gemm<false, false, D, BK>(sdS + r0 * L::LDP, L::LDP, sK, L::LDT, sdQ + r0 * L::LDO,
                                   L::LDO, true);
  }
  __syncthreads();

  T* dqb = dq + qoff;
  for (int r = r0; r < r0 + WROWS; ++r) {
    const int qi = q0 + r;
    if (qi >= Sq) break;
    for (int c = lane; c < D; c += 32) dqb[(size_t)qi * D + c] = from_f<T>(scale * sdQ[r * L::LDO + c]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (bh, K tile); loop over Q tiles.
// dV = sum_i P_ij^T dO_i; dK = scale * sum_i dS_ij^T Q_i.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ glse,
                 T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, float scale,
                 int causal, int q_offset, int k_offset) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * L::LDT;
  T* sQ = sV + BK * L::LDT;
  T* sdO = sQ + BQ * L::LDT;
  float* sS = reinterpret_cast<float*>(sdO + BQ * L::LDT);
  float* sdP = sS + BQ * L::LDS;
  T* sP = reinterpret_cast<T*>(sdP + BQ * L::LDS);
  T* sdS = sP + BQ * L::LDP;
  float* sdK = reinterpret_cast<float*>(sdS + BQ * L::LDP);
  float* sdV = sdK + BK * L::LDO;
  float* sLse = sdV + BK * L::LDO;
  float* sDelta = sLse + BQ;
  float* sGlse = sDelta + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * WROWS;
  const size_t qoff = (size_t)bh * Sq * D;
  const size_t koff = (size_t)bh * Sk * D;

  load_tile<T, D, BK, NTHREADS>(sK, L::LDT, k + koff, k0, Sk);
  load_tile<T, D, BK, NTHREADS>(sV, L::LDT, v + koff, k0, Sk);
  for (int i = threadIdx.x; i < BK * L::LDO; i += NTHREADS) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }

  for (int q0 = query_begin(k0, causal, q_offset, k_offset); q0 < Sq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous Q, dO, P, dS
    load_tile<T, D, BQ, NTHREADS>(sQ, L::LDT, q + qoff, q0, Sq);
    load_tile<T, D, BQ, NTHREADS>(sdO, L::LDT, dout + qoff, q0, Sq);
    load_rows<BQ, NTHREADS>(sLse, lse + (size_t)bh * Sq, q0, Sq);
    load_rows<BQ, NTHREADS>(sDelta, delta + (size_t)bh * Sq, q0, Sq);
    load_rows<BQ, NTHREADS>(sGlse, glse + (size_t)bh * Sq, q0, Sq);
    __syncthreads();

    // Scores for this warp's 16 Q rows against the block's 64 keys.
    warp_gemm<false, true, BK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT, sS + r0 * L::LDS,
                                  L::LDS, false);
    warp_gemm<false, true, BK, D>(sdO + r0 * L::LDT, L::LDT, sV, L::LDT, sdP + r0 * L::LDS,
                                  L::LDS, false);
    __syncwarp();
    probs_and_dscores<T, L::LDS, L::LDP>(sS, sdP, sLse, sDelta, sGlse, sP, sdS, r0, q0, k0,
                                         Sq, Sk, scale, causal, q_offset, k_offset);
    __syncthreads();  // the transposed products read every warp's rows

    // This warp's 16 key rows: contraction over the 64 Q rows.
    warp_gemm<true, false, D, BQ>(sP + r0, L::LDP, sdO, L::LDT, sdV + r0 * L::LDO, L::LDO,
                                  true);
    warp_gemm<true, false, D, BQ>(sdS + r0, L::LDP, sQ, L::LDT, sdK + r0 * L::LDO, L::LDO,
                                  true);
  }
  __syncthreads();

  for (int r = r0; r < r0 + WROWS; ++r) {
    const int kj = k0 + r;
    if (kj >= Sk) break;
    for (int c = lane; c < D; c += 32) {
      dk[koff + (size_t)kj * D + c] = from_f<T>(scale * sdK[r * L::LDO + c]);
      dv[koff + (size_t)kj * D + c] = from_f<T>(sdV[r * L::LDO + c]);
    }
  }
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  using L = Layout<T, D>;
  return (size_t)(BQ + 2 * BK) * L::LDT * sizeof(T) + BQ * L::LDS * sizeof(float) +
         BQ * L::LDP * sizeof(T) + BQ * L::LDO * sizeof(float) + 2 * BQ * sizeof(float);
}

template <typename T, int D>
constexpr size_t dq_smem() {
  using L = Layout<T, D>;
  return (size_t)(2 * BQ + 2 * BK) * L::LDT * sizeof(T) + 2 * BQ * L::LDS * sizeof(float) +
         BQ * L::LDP * sizeof(T) + BQ * L::LDO * sizeof(float) + 3 * BQ * sizeof(float);
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  using L = Layout<T, D>;
  return (size_t)(2 * BQ + 2 * BK) * L::LDT * sizeof(T) + 2 * BQ * L::LDS * sizeof(float) +
         2 * BQ * L::LDP * sizeof(T) + 2 * BK * L::LDO * sizeof(float) +
         3 * BQ * sizeof(float);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int Sq, int Sk, float scale, int causal, int qo, int ko,
                       cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<T, D>();
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Sq, Sk, scale, causal, qo, ko);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dq, int BH,
                      int Sq, int Sk, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem<T, D>();
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (const float*)glse, (T*)dq, Sq, Sk, scale, causal, qo, ko);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                       int BH, int Sq, int Sk, float scale, int causal, int qo, int ko,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<T, D>();
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK, BH);
  flash_dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (const float*)glse, (T*)dk, (T*)dv, Sq, Sk, scale, causal, qo, ko);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                  int Sq, int Sk, int D, int dtype, int causal, int q_offset, int k_offset,
                  float scale, void* stream) {
  HVD_DISPATCH(dtype, D,
               (int)(launch_fwd<T, HD>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, q_offset,
                                       k_offset, (cudaStream_t)stream)));
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* glse, void* dq, int BH, int Sq,
                 int Sk, int D, int dtype, int causal, int q_offset, int k_offset, float scale,
                 void* stream) {
  HVD_DISPATCH(dtype, D,
               (int)(launch_dq<T, HD>(q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, scale,
                                      causal, q_offset, k_offset, (cudaStream_t)stream)));
}

int hvd_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                  int BH, int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                  int k_offset, float scale, void* stream) {
  HVD_DISPATCH(dtype, D,
               (int)(launch_dkv<T, HD>(q, k, v, dout, lse, delta, glse, dk, dv, BH, Sq, Sk,
                                       scale, causal, q_offset, k_offset,
                                       (cudaStream_t)stream)));
}

// The message of any entry point's error code, for every source of the
// library (horovod_tpu_torch/ops/_kernels.py raises it).
const char* hvd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
