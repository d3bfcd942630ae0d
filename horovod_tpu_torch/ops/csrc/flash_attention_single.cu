// Single-tile flash attention for Hopper (sm_90a): a direct-softmax forward
// and a fused backward, for sequences of at most SMAX = 128 rows of Q and of
// K/V (SINGLE_TILE_MAX in horovod_tpu_torch/ops/attention.py, which routes
// longer sequences to the multi-tile kernels of flash_attention.cu).
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/attention.py:
//   flash_fwd_single_kernel <- _flash_fwd_single_kernel (:310)
//   flash_dqkv_kernel       <- _flash_dqkv_fused_kernel (:343)
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
//   Forward: one block per (bh, 64-row Q tile), four warps of 16 Q rows.
//     Scores are computed once: m = rowmax, p = exp(s - m), l = rowsum,
//     o = (p in the operand dtype) V / l. The fp32 output reuses the score
//     buffer, so a bf16 D = 64 block needs 102 KB and two blocks share an SM.
//   Backward: one block per bh, eight warps. K and V stay resident; Q, dO and
//     their row vectors come in 32-row chunks. Per chunk the block computes
//     S = Q K^T and dP = dO V^T (16 x 16 tiles spread over the warps), then
//     P and dS in the operand dtype, then writes dQ = scale dS K for the
//     chunk. Each warp owns 16 key rows and accumulates their dV = P^T dO and
//     dK = scale dS^T Q in registers across chunks, so each output has one
//     owner and no atomics are needed. fp32 S and dP of a whole 128 x 128
//     tile next to dK and dV in fp32 would not fit 227 KB at D = 128; the
//     32-row chunks keep a bf16 D = 128 block at 142 KB.
// Products take the stored dtype (bf16 on tensor cores through WMMA 16x16x16
// fragments, fp32 accumulation; float32 on the FMA units), and P and dS are
// rounded to the operand dtype before the PV, P^T dO, dS K and dS^T Q
// products, as the TPU kernels do. This is the simple first version: no TMA,
// no wgmma, no pipelining of loads against compute.
//
// Semantics (identical to the TPU kernels): causal masking on global
// positions q_offset + i >= k_offset + j; a row with no visible key gives
// O = 0 and lse = 1e30; dS = P * (dO V^T - delta + g_lse). Any Sq, Sk up to
// 128 works: rows and keys past the end are masked.
//
// C interface: every entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).

#include "flash_common.cuh"

namespace {

constexpr int SMAX = 128;  // most rows of Q or of K/V
constexpr int FWD_BQ = 64;  // Q rows of one forward block
constexpr int FWD_THREADS = 128;  // four warps of 16 rows
constexpr int QC = 32;  // Q rows of one backward chunk
constexpr int BWD_WARPS = 8;  // each owns 16 of the SMAX key rows
constexpr int BWD_THREADS = BWD_WARPS * 32;

static_assert(FWD_THREADS / 32 * 16 == FWD_BQ, "one 16-row slice per forward warp");
static_assert(BWD_WARPS * 16 == SMAX, "one 16-key slice per backward warp");

// Leading dimensions in shared memory, padded by 32 bytes for T: every WMMA
// fragment pointer stays 256-bit aligned and rows fall on different banks.
template <typename T, int D>
struct SingleLayout {
  static constexpr int LDT = D + 32 / (int)sizeof(T);      // operand tiles
  static constexpr int LDS = SMAX + 8;                      // fp32 scores
  static constexpr int LDP = SMAX + 32 / (int)sizeof(T);    // P / dS in T
  static constexpr int LDO = D + 8;                         // fp32 outputs
};

// ---------------------------------------------------------------------------
// Forward: o [BH, Sq, D], lse [BH, Sq] fp32.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_single_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                        int Sq, int Sk, float scale, int causal, int q_offset, int k_offset) {
  using L = SingleLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + FWD_BQ * L::LDT;
  T* sV = sK + SMAX * L::LDT;
  float* sS = reinterpret_cast<float*>(sV + SMAX * L::LDT);  // scores, then the output
  T* sP = reinterpret_cast<T*>(sS + FWD_BQ * L::LDS);
  float* sL = reinterpret_cast<float*>(sP + FWD_BQ * L::LDP);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FWD_BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  load_tile<T, D, FWD_BQ, FWD_THREADS>(sQ, L::LDT, q + (size_t)bh * Sq * D, q0, Sq);
  load_tile<T, D, SMAX, FWD_THREADS>(sK, L::LDT, k + (size_t)bh * Sk * D, 0, Sk);
  load_tile<T, D, SMAX, FWD_THREADS>(sV, L::LDT, v + (size_t)bh * Sk * D, 0, Sk);
  __syncthreads();

  warp_gemm<false, true, SMAX, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT, sS + r0 * L::LDS,
                                  L::LDS, false);
  __syncwarp();
  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    float s[SMAX / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int h = 0; h < SMAX / 32; ++h) {
      const int c = lane + 32 * h;
      s[h] = visible(qi, c, Sq, Sk, causal, q_offset, k_offset) ? sS[r * L::LDS + c] * scale
                                                                : NEG_INF;
      mx = fmaxf(mx, s[h]);
    }
    const float m = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < SMAX / 32; ++h) {
      const int c = lane + 32 * h;
      const float p = visible(qi, c, Sq, Sk, causal, q_offset, k_offset) ? expf(s[h] - m) : 0.f;
      sP[r * L::LDP + c] = from_f<T>(p);
      sum += p;
    }
    const float l = warp_sum(sum);
    if (lane == 0) {
      sL[r] = l;
      if (qi < Sq) lse[(size_t)bh * Sq + qi] = l == 0.f ? LSE_MASKED : m + logf(l);
    }
  }
  __syncthreads();  // every warp is done with the scores: the output reuses them

  float* sO = sS;
  warp_gemm<false, false, D, SMAX>(sP + r0 * L::LDP, L::LDP, sV, L::LDT, sO + r0 * L::LDO,
                                   L::LDO, false);
  __syncwarp();
  T* ob = o + (size_t)bh * Sq * D;
  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= Sq) break;
    const float safe_l = sL[r] == 0.f ? 1.f : sL[r];
    for (int c = lane; c < D; c += 32) ob[(size_t)qi * D + c] = from_f<T>(sO[r * L::LDO + c] / safe_l);
  }
}

// ---------------------------------------------------------------------------
// Fused backward: dq [BH, Sq, D], dk and dv [BH, Sk, D] from one pass.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dqkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const float* __restrict__ glse,
                  T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                  float scale, int causal, int q_offset, int k_offset) {
  using L = SingleLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + SMAX * L::LDT;
  // Chunk buffers; after the last chunk, each warp's dK/dV staging tile.
  T* sQ = sV + SMAX * L::LDT;
  T* sdO = sQ + QC * L::LDT;
  float* sS = reinterpret_cast<float*>(sdO + QC * L::LDT);
  float* sdP = sS + QC * L::LDS;
  T* sP = reinterpret_cast<T*>(sdP + QC * L::LDS);
  T* sdS = sP + QC * L::LDP;
  float* sLse = reinterpret_cast<float*>(sdS + QC * L::LDP);
  float* sDelta = sLse + QC;
  float* sGlse = sDelta + QC;

  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key0 = warp * 16;
  const size_t qoff = (size_t)bh * Sq * D;
  const size_t koff = (size_t)bh * Sk * D;

  load_tile<T, D, SMAX, BWD_THREADS>(sK, L::LDT, k + koff, 0, Sk);
  load_tile<T, D, SMAX, BWD_THREADS>(sV, L::LDT, v + koff, 0, Sk);
  RowAcc<T, D> acc_dv, acc_dk;
  acc_dv.zero();
  acc_dk.zero();

  for (int q0 = 0; q0 < Sq; q0 += QC) {
    __syncthreads();  // every warp is done with the previous chunk
    load_tile<T, D, QC, BWD_THREADS>(sQ, L::LDT, q + qoff, q0, Sq);
    load_tile<T, D, QC, BWD_THREADS>(sdO, L::LDT, dout + qoff, q0, Sq);
    load_rows<QC, BWD_THREADS>(sLse, lse + (size_t)bh * Sq, q0, Sq);
    load_rows<QC, BWD_THREADS>(sDelta, delta + (size_t)bh * Sq, q0, Sq);
    load_rows<QC, BWD_THREADS>(sGlse, glse + (size_t)bh * Sq, q0, Sq);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, as 16 x 16 tiles spread over the warps.
    constexpr int NT = (QC / 16) * (SMAX / 16);
    for (int t = warp; t < 2 * NT; t += BWD_WARPS) {
      const bool grad = t >= NT;
      const int rs = (t % NT) / (SMAX / 16);
      const int cs = (t % NT) % (SMAX / 16);
      warp_gemm<false, true, 16, D>((grad ? sdO : sQ) + rs * 16 * L::LDT, L::LDT,
                                    (grad ? sV : sK) + cs * 16 * L::LDT, L::LDT,
                                    (grad ? sdP : sS) + rs * 16 * L::LDS + cs * 16, L::LDS,
                                    false);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < QC * SMAX; idx += BWD_THREADS) {
      const int r = idx / SMAX;
      const int c = idx % SMAX;
      float p = 0.f, ds = 0.f;
      if (visible(q0 + r, c, Sq, Sk, causal, q_offset, k_offset)) {
        p = expf(sS[r * L::LDS + c] * scale - sLse[r]);
        ds = p * (sdP[r * L::LDS + c] - sDelta[r] + sGlse[r]);
      }
      sP[r * L::LDP + c] = from_f<T>(p);
      sdS[r * L::LDP + c] = from_f<T>(ds);
    }
    __syncthreads();

    // dQ of the chunk, tile by tile, staged in the score buffer (free now).
    constexpr int NQT = (QC / 16) * (D / 16);
    for (int t = warp; t < NQT; t += BWD_WARPS) {
      const int rs = t / (D / 16);
      const int cs = t % (D / 16);
      float* st = sS + rs * 16 * L::LDS + cs * 16;
      warp_gemm<false, false, 16, SMAX>(sdS + rs * 16 * L::LDP, L::LDP, sK + cs * 16, L::LDT, st,
                                        L::LDS, false);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int qi = q0 + rs * 16 + e / 16;
        if (qi < Sq) dq[qoff + (size_t)qi * D + cs * 16 + e % 16] = from_f<T>(scale * st[(e / 16) * L::LDS + e % 16]);
      }
    }

    // This warp's 16 key rows: contraction over the chunk's Q rows.
    if (key0 < Sk) {
      acc_dv.template add_at_b<QC>(sP + key0, L::LDP, sdO, L::LDT);
      acc_dk.template add_at_b<QC>(sdS + key0, L::LDP, sQ, L::LDT);
    }
  }
  __syncthreads();  // the chunk buffers become staging tiles

  if (key0 >= Sk) return;
  float* st = reinterpret_cast<float*>(sQ) + warp * 16 * L::LDO;
  auto write = [&](const RowAcc<T, D>& acc, T* out, float mul) {
    acc.store(st, L::LDO);
    __syncwarp();
    for (int e = lane; e < 16 * D; e += 32) {
      const int kj = key0 + e / D;
      if (kj < Sk) out[koff + (size_t)kj * D + e % D] = from_f<T>(mul * st[(e / D) * L::LDO + e % D]);
    }
    __syncwarp();
  };
  write(acc_dv, dv, 1.f);
  write(acc_dk, dk, scale);
}

template <typename T, int D>
constexpr size_t fwd_single_smem() {
  using L = SingleLayout<T, D>;
  return (size_t)(FWD_BQ + 2 * SMAX) * L::LDT * sizeof(T) + FWD_BQ * L::LDS * sizeof(float) +
         FWD_BQ * L::LDP * sizeof(T) + FWD_BQ * sizeof(float);
}

template <typename T, int D>
constexpr size_t dqkv_smem() {
  using L = SingleLayout<T, D>;
  constexpr size_t chunk = (size_t)2 * QC * L::LDT * sizeof(T) + 2 * QC * L::LDS * sizeof(float) +
                           2 * QC * L::LDP * sizeof(T) + 3 * QC * sizeof(float);
  constexpr size_t staging = (size_t)BWD_WARPS * 16 * L::LDO * sizeof(float);
  return (size_t)2 * SMAX * L::LDT * sizeof(T) + (chunk > staging ? chunk : staging);
}

template <typename T, int D>
cudaError_t launch_fwd_single(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int Sq, int Sk, float scale, int causal, int qo, int ko,
                              cudaStream_t stream) {
  constexpr size_t smem = fwd_single_smem<T, D>();
  static_assert(smem <= SMEM_LIMIT, "forward tiles exceed a block's shared memory");
  if (Sq < 1 || Sk < 1 || Sq > SMAX || Sk > SMAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_single_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, BH);
  flash_fwd_single_kernel<T, D><<<grid, FWD_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Sq, Sk, scale, causal, qo, ko);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dqkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* glse, void* dq, void* dk,
                        void* dv, int BH, int Sq, int Sk, float scale, int causal, int qo, int ko,
                        cudaStream_t stream) {
  constexpr size_t smem = dqkv_smem<T, D>();
  static_assert(smem <= SMEM_LIMIT, "backward tiles exceed a block's shared memory");
  if (Sq < 1 || Sk < 1 || Sq > SMAX || Sk > SMAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_dqkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_dqkv_kernel<T, D><<<BH, BWD_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (const float*)glse, (T*)dq, (T*)dk, (T*)dv, Sq, Sk, scale, causal, qo,
      ko);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hvd_flash_fwd_single(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                         int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                         int k_offset, float scale, void* stream) {
  HVD_DISPATCH(dtype, D,
               (int)(launch_fwd_single<T, HD>(q, k, v, o, lse, BH, Sq, Sk, scale, causal,
                                              q_offset, k_offset, (cudaStream_t)stream)));
}

int hvd_flash_dqkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* glse, void* dq, void* dk,
                   void* dv, int BH, int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                   int k_offset, float scale, void* stream) {
  HVD_DISPATCH(dtype, D,
               (int)(launch_dqkv<T, HD>(q, k, v, dout, lse, delta, glse, dq, dk, dv, BH, Sq, Sk,
                                        scale, causal, q_offset, k_offset,
                                        (cudaStream_t)stream)));
}

}  // extern "C"
