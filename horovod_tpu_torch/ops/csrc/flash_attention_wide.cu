// Flash attention at head dims above 256: the wide-head route.
//
// Replaces, at any head dim D, the Pallas kernels of
// horovod_tpu/ops/attention.py: _flash_fwd_kernel (:138, forward: O and
// lse), _flash_dq_kernel (:198, dQ) and _flash_dkv_kernel (:252, dK and
// dV). The kernels of flash_attention.cu keep every output row of a tile in
// registers across the whole of D, which stops at D = 256. Here nothing that
// a block holds grows with D:
//
// - the scores S = Q K^T (and dP = dO V^T) are contractions over D, streamed
//   through shared memory in chunks of W_KC columns into a 64 x 64 fp32 tile
//   held in registers (16 values per thread);
// - every output is written in column slices of W_SL columns, one slice at a
//   time, each slice recomputing the scores it needs. The forward first runs
//   one pass over the keys for the row max and sum (so lse), after which
//   P = exp(S - lse) is final and a slice is O_slice = P V_slice with no
//   rescaling. dQ_slice = scale * dS K_slice and, per key tile,
//   dV_slice = P^T dO_slice, dK_slice = scale * dS^T Q_slice.
//
// So the registers (at most 2 x 32 accumulators per thread) and the shared
// memory (49,408 / 50,432 / 98,816 bytes for the forward, dQ and dK/dV) are
// the same at D = 320 as at D = 1024. The price is recomputation: the scores
// are computed once per slice (forward: 1 + ceil(D / 128) times). These are
// first versions on the FMA units in fp32 (SIMT, no tensor cores): bound by
// operations, at the float32 rate. The operand dtype (float32, bf16, float16)
// is converted to fp32 as it is loaded; P and dS stay in fp32.
//
// D must be a multiple of W_KC (the wrapper zero-pads it with the scale of
// the true D, attention.py:padded_heads); any B*H, ragged Sq and Sk, causal
// masking on global positions q_offset + i >= k_offset + j, LSE_MASKED for
// rows that see no key, and the lse cotangent g_lse as the other routes.

#include "flash_common.cuh"

namespace {

constexpr int W_BM = 64;            // Q rows of a tile
constexpr int W_BN = 64;            // K/V rows of a tile
constexpr int W_KC = 32;            // columns of D per chunk of a score contraction
constexpr int W_SL = 128;           // output columns per slice
constexpr int W_THREADS = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int W_LDC = W_KC + 1;     // leading dim of a chunk in shared memory
constexpr int W_LDP = W_BN + 1;     // leading dim of the P / dS tile
constexpr int W_NJ = W_SL / 16;     // slice columns per thread
constexpr int W_CHUNK = W_BM * W_LDC;  // floats of one chunk buffer
constexpr int W_SLICE = W_BN * W_SL;   // floats of one slice buffer
constexpr int W_TILE = W_BM * W_LDP;   // floats of one P / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T of_f(float x);
template <>
__device__ __forceinline__ float of_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 of_f<bf16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ f16 of_f<f16>(float x) { return __float2half(x); }

// Rows [row0, row0 + ROWS) and columns [col0, col0 + W) of a row-major
// [nrows, D] matrix into fp32 shared memory (leading dim ld), 16 bytes per
// load; zero past nrows and past D (D and col0 are multiples of W_KC).
template <typename T, int ROWS, int W>
__device__ __forceinline__ void load_block(float* dst, int ld, const T* __restrict__ src, int D,
                                           int row0, int nrows, int col0) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = W / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += W_THREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * VEC;
    const int gr = row0 + r, gc = col0 + c;
    float* d = dst + r * ld + c;
    if (gr < nrows && gc < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + gc);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = 0.f;
    }
  }
}

// The 64 x 64 tile S = A B^T (and, with DP, dP = C E^T) of rows [a0, a0 + 64)
// of A, C and rows [b0, b0 + 64) of B, E, contracted over all of D in chunks
// of W_KC columns. Thread (ty, tx) holds rows ty + 16 i and columns tx + 16 j.
// Starts with a barrier, so the caller may reuse the chunk buffers freely
// before it; ends without one.
template <typename T, bool DP>
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], float* buf,
                                       const T* a, const T* b, const T* c, const T* e, int a0,
                                       int na, int b0, int nb, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* sA = buf;
  float* sB = buf + W_CHUNK;
  float* sC = buf + 2 * W_CHUNK;
  float* sE = buf + 3 * W_CHUNK;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int c0 = 0; c0 < D; c0 += W_KC) {
    __syncthreads();
    load_block<T, W_BM, W_KC>(sA, W_LDC, a, D, a0, na, c0);
    load_block<T, W_BN, W_KC>(sB, W_LDC, b, D, b0, nb, c0);
    if (DP) {
      load_block<T, W_BM, W_KC>(sC, W_LDC, c, D, a0, na, c0);
      load_block<T, W_BN, W_KC>(sE, W_LDC, e, D, b0, nb, c0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < W_KC; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sA[(ty + 16 * i) * W_LDC + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sB[(tx + 16 * j) * W_LDC + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
      if (DP) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = sC[(ty + 16 * i) * W_LDC + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = sE[(tx + 16 * j) * W_LDC + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(x[i], y[j], dp[i][j]);
      }
    }
  }
}

// Max and sum over the 16 threads that share a row (one half of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K/V tiles that rows [q0, q0 + W_BM) of Q can see.
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal, int qo, int ko) {
  const int n = (Sk + W_BN - 1) / W_BN;
  if (!causal) return n;
  const int kmax = qo + min(q0 + W_BM, Sq) - 1 - ko;  // last visible key
  if (kmax < 0) return 0;
  return min(n, kmax / W_BN + 1);
}

// First Q tile whose rows can see a key of the K/V tile at k0.
__device__ __forceinline__ int first_query_tile(int k0, int causal, int qo, int ko) {
  if (!causal) return 0;
  const int qmin = ko + k0 - qo;  // first row that sees key k0
  return qmin <= 0 ? 0 : qmin / W_BM;
}

// acc[i][j] += sum_kk L(row i, kk) R(kk, col j), with L read from a 64 x 64
// fp32 tile (transposed when LT) and R from a [64][W_SL] slice.
template <bool LT>
__device__ __forceinline__ void slice_product(float (&acc)[4][W_NJ], const float* sL,
                                              const float* sR) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    float x[4], y[W_NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = LT ? sL[kk * W_LDP + ty + 16 * i] : sL[(ty + 16 * i) * W_LDP + kk];
#pragma unroll
    for (int j = 0; j < W_NJ; ++j) y[j] = sR[kk * W_SL + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < W_NJ; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_slice(T* out, const float (&acc)[4][W_NJ], float mul,
                                            int row0, int nrows, int c0, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < W_NJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < D) out[(size_t)r * D + c] = of_f<T>(mul * acc[i][j]);
    }
  }
}

// Forward: one block per (Q tile, head). o [BH, Sq, D], lse [BH, Sq] fp32.
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int BH, int Sq, int Sk, int D, float scale, int causal, int qo,
                          int ko) {
  extern __shared__ float4 wide_smem[];
  float* buf = reinterpret_cast<float*>(wide_smem);  // chunks, then a V slice
  float* sP = buf + (2 * W_CHUNK > W_SLICE ? 2 * W_CHUNK : W_SLICE);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * W_BM;
  const int nk = key_tiles(q0, Sq, Sk, causal, qo, ko);
  float s[4][4], unused[4][4];
  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const T* qh = q + (size_t)bh * Sq * D;
    const T* kh = k + (size_t)bh * Sk * D;
    const T* vh = v + (size_t)bh * Sk * D;
    // Pass 1: the row max and sum, so lse.
    float m[4], l[4], L[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = NEG_INF, l[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * W_BN;
      scores<T, false>(s, unused, buf, qh, kh, nullptr, nullptr, q0, Sq, k0, Sk, D);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool vis = visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, qo, ko);
          s[i][j] = vis ? s[i][j] * scale : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
        const float mn = fmaxf(m[i], row_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, qo, ko)) sum += expf(s[i][j] - mn);
        l[i] = l[i] * expf(m[i] - mn) + row_sum(sum);
        m[i] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      L[i] = l[i] == 0.f ? LSE_MASKED : m[i] + logf(l[i]);
      const int qi = q0 + ty + 16 * i;
      if (tx == 0 && qi < Sq) lse[(size_t)bh * Sq + qi] = L[i];
    }
    // Pass 2: per column slice, O_slice = P V_slice with P = exp(S - lse).
    for (int c0 = 0; c0 < D; c0 += W_SL) {
      float acc[4][W_NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < W_NJ; ++j) acc[i][j] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * W_BN;
        scores<T, false>(s, unused, buf, qh, kh, nullptr, nullptr, q0, Sq, k0, Sk, D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool vis = visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, qo, ko);
            sP[(ty + 16 * i) * W_LDP + tx + 16 * j] = vis ? expf(s[i][j] * scale - L[i]) : 0.f;
          }
        }
        __syncthreads();
        load_block<T, W_BN, W_SL>(buf, W_SL, vh, D, k0, Sk, c0);
        __syncthreads();
        slice_product<false>(acc, sP, buf);
      }
      store_slice<T>(o + (size_t)bh * Sq * D, acc, 1.f, q0, Sq, c0, D);
    }
  }
}

// dQ: one block per (Q tile, head). dQ = scale * dS K with
// dS = P * (dO V^T - delta + g_lse); lse, delta, glse [BH, Sq] fp32.
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
    flash_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ glse, T* __restrict__ dq, int BH, int Sq,
                         int Sk, int D, float scale, int causal, int qo, int ko) {
  extern __shared__ float4 wide_smem[];
  float* buf = reinterpret_cast<float*>(wide_smem);  // chunks, then a K slice
  float* sP = buf + (4 * W_CHUNK > W_SLICE ? 4 * W_CHUNK : W_SLICE);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * W_BM;
  const int nk = key_tiles(q0, Sq, Sk, causal, qo, ko);
  float s[4][4], dp[4][4];
  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
    float L[4], dl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      const size_t r = (size_t)bh * Sq + qi;
      L[i] = qi < Sq ? lse[r] : 0.f;
      dl[i] = qi < Sq ? glse[r] - delta[r] : 0.f;
    }
    for (int c0 = 0; c0 < D; c0 += W_SL) {
      float acc[4][W_NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < W_NJ; ++j) acc[i][j] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * W_BN;
        scores<T, true>(s, dp, buf, q + qoff, k + koff, dout + qoff, v + koff, q0, Sq, k0, Sk,
                        D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool vis = visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, qo, ko);
            const float p = vis ? expf(s[i][j] * scale - L[i]) : 0.f;
            sP[(ty + 16 * i) * W_LDP + tx + 16 * j] = p * (dp[i][j] + dl[i]);
          }
        }
        __syncthreads();
        load_block<T, W_BN, W_SL>(buf, W_SL, k + koff, D, k0, Sk, c0);
        __syncthreads();
        slice_product<false>(acc, sP, buf);
      }
      store_slice<T>(dq + qoff, acc, scale, q0, Sq, c0, D);
    }
  }
}

// dK, dV: one block per (K/V tile, head). dV = P^T dO, dK = scale * dS^T Q.
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
    flash_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ glse, T* __restrict__ dk,
                          T* __restrict__ dv, int BH, int Sq, int Sk, int D, float scale,
                          int causal, int qo, int ko) {
  extern __shared__ float4 wide_smem[];
  float* buf = reinterpret_cast<float*>(wide_smem);  // chunks, then dO and Q slices
  float* sP = buf + (4 * W_CHUNK > 2 * W_SLICE ? 4 * W_CHUNK : 2 * W_SLICE);
  float* sdS = sP + W_TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * W_BN;
  const int nq = (Sq + W_BM - 1) / W_BM;
  const int qt0 = first_query_tile(k0, causal, qo, ko);
  float s[4][4], dp[4][4];
  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
    for (int c0 = 0; c0 < D; c0 += W_SL) {
      float acck[4][W_NJ], accv[4][W_NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < W_NJ; ++j) acck[i][j] = accv[i][j] = 0.f;
      for (int qt = qt0; qt < nq; ++qt) {
        const int q0 = qt * W_BM;
        scores<T, true>(s, dp, buf, q + qoff, k + koff, dout + qoff, v + koff, q0, Sq, k0, Sk,
                        D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
          const size_t r = (size_t)bh * Sq + qi;
          const float Li = qi < Sq ? lse[r] : 0.f;
          const float dl = qi < Sq ? glse[r] - delta[r] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool vis = visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, qo, ko);
            const float p = vis ? expf(s[i][j] * scale - Li) : 0.f;
            sP[(ty + 16 * i) * W_LDP + tx + 16 * j] = p;
            sdS[(ty + 16 * i) * W_LDP + tx + 16 * j] = p * (dp[i][j] + dl);
          }
        }
        __syncthreads();
        load_block<T, W_BM, W_SL>(buf, W_SL, dout + qoff, D, q0, Sq, c0);
        load_block<T, W_BM, W_SL>(buf + W_SLICE, W_SL, q + qoff, D, q0, Sq, c0);
        __syncthreads();
        slice_product<true>(accv, sP, buf);
        slice_product<true>(acck, sdS, buf + W_SLICE);
      }
      store_slice<T>(dk + koff, acck, scale, k0, Sk, c0, D);
      store_slice<T>(dv + koff, accv, 1.f, k0, Sk, c0, D);
    }
  }
}

constexpr size_t FWD_WIDE_SMEM =
    ((2 * W_CHUNK > W_SLICE ? 2 * W_CHUNK : W_SLICE) + W_TILE) * sizeof(float);
constexpr size_t DQ_WIDE_SMEM =
    ((4 * W_CHUNK > W_SLICE ? 4 * W_CHUNK : W_SLICE) + W_TILE) * sizeof(float);
constexpr size_t DKV_WIDE_SMEM =
    ((4 * W_CHUNK > 2 * W_SLICE ? 4 * W_CHUNK : 2 * W_SLICE) + 2 * W_TILE) * sizeof(float);
static_assert(DKV_WIDE_SMEM <= SMEM_LIMIT, "wide dK/dV tiles exceed shared memory");

template <typename Kernel, typename... Args>
int launch_wide(Kernel kernel, int rows, int BH, int D, size_t smem, cudaStream_t stream,
                Args... args) {
  if (D <= 0 || D % W_KC) return cudaErrorInvalidValue;
  if (rows == 0 || BH == 0) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + 63) / 64, BH < 65535 ? BH : 65535);
  kernel<<<grid, W_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

#define HVD_DISPATCH_T(DTYPE, CALL)        \
  do {                                     \
    if ((DTYPE) == DTYPE_BF16) {           \
      using T = bf16;                      \
      return CALL;                         \
    } else if ((DTYPE) == DTYPE_F16) {     \
      using T = f16;                       \
      return CALL;                         \
    } else if ((DTYPE) == DTYPE_F32) {     \
      using T = float;                     \
      return CALL;                         \
    }                                      \
    return cudaErrorInvalidValue;          \
  } while (0)

}  // namespace

extern "C" {

int hvd_flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int Sq, int Sk, int D, int dtype, int causal, int q_offset, int k_offset,
                       float scale, void* stream) {
  HVD_DISPATCH_T(dtype, (launch_wide(flash_fwd_wide_kernel<T>, Sq, BH, D, FWD_WIDE_SMEM,
                                     (cudaStream_t)stream, (const T*)q, (const T*)k,
                                     (const T*)v, (T*)o, (float*)lse, BH, Sq, Sk, D, scale,
                                     causal, q_offset, k_offset)));
}

int hvd_flash_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dq, int BH,
                      int Sq, int Sk, int D, int dtype, int causal, int q_offset, int k_offset,
                      float scale, void* stream) {
  HVD_DISPATCH_T(dtype,
                 (launch_wide(flash_dq_wide_kernel<T>, Sq, BH, D, DQ_WIDE_SMEM,
                              (cudaStream_t)stream, (const T*)q, (const T*)k, (const T*)v,
                              (const T*)dout, (const float*)lse, (const float*)delta,
                              (const float*)glse, (T*)dq, BH, Sq, Sk, D, scale, causal, q_offset,
                              k_offset)));
}

int hvd_flash_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                       int BH, int Sq, int Sk, int D, int dtype, int causal, int q_offset,
                       int k_offset, float scale, void* stream) {
  HVD_DISPATCH_T(dtype,
                 (launch_wide(flash_dkv_wide_kernel<T>, Sk, BH, D, DKV_WIDE_SMEM,
                              (cudaStream_t)stream, (const T*)q, (const T*)k, (const T*)v,
                              (const T*)dout, (const float*)lse, (const float*)delta,
                              (const float*)glse, (T*)dk, (T*)dv, BH, Sq, Sk, D, scale, causal,
                              q_offset, k_offset)));
}

}  // extern "C"
