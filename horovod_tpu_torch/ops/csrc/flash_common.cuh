// Device helpers shared by the port's CUDA kernels (flash_attention.cu,
// flash_attention_single.cu, conv1x1_dw.cu): dtype conversion, warp
// reductions, tile loads into shared memory, one warp's 16-row float32
// matrix product and register accumulator (the float32 first versions of
// the kernels), the causal visibility rule, and the (dtype, head dim)
// dispatch of the C entry points.
//
// Everything sits in an anonymous namespace: each translation unit gets its
// own copy, so the sources link into one library without clashes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LSE_MASKED = 1e30f;
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

// dtype codes shared with horovod_tpu_torch/ops/_kernels.py.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + ROWS) of a row-major [nrows, D] matrix into shared
// memory (leading dimension ld), 16 bytes per thread of an NT-thread block,
// zero past the end.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int row0,
                                          int nrows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += NT) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Copy ROWS per-row fp32 values starting at row0, zero past the end.
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int nrows) {
  for (int r = threadIdx.x; r < ROWS; r += NT) dst[r] = (row0 + r < nrows) ? src[row0 + r] : 0.f;
}

// One warp: C[16 x N] (+)= A[16 x K] * B[K x N], fp32 C row-major in shared
// memory. A_T: A is stored transposed (A(i, k) = A[k * lda + i]). B_T: B is
// stored as [N][K] (B(k, n) = B[n * ldb + k]). float32 operands on the FMA
// units (the tensor cores' TF32 would round them to 10 mantissa bits).
template <bool A_T, bool B_T, int N, int K>
__device__ __forceinline__ void warp_gemm(const float* A, int lda, const float* B, int ldb,
                                          float* C, int ldc, bool accumulate) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N;
    const int n = idx % N;
    float acc = accumulate ? C[i * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_T ? A[k * lda + i] : A[i * lda + k];
      const float b = B_T ? B[n * ldb + k] : B[k * ldb + n];
      acc = fmaf(a, b, acc);
    }
    C[i * ldc + n] = acc;
  }
}

// One warp's fp32 accumulator C[16 x N], held in registers across calls:
// C += A^T B, where A is stored [K][16] (A^T(i, k) = A[k * lda + i]) and B is
// row-major [K x N], both in shared memory. The float32 flash backward keeps
// dK and dV of 16 key rows in it; the float32 1x1-conv filter gradient keeps
// 16 input channels.
template <typename T, int N>
struct RowAcc;

template <int N>
struct RowAcc<float, N> {
  static constexpr int E = 16 * N / 32;  // elements per lane
  float f[E];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = 0.f;
  }

  template <int K>
  __device__ __forceinline__ void add_at_b(const float* A, int lda, const float* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = (lane + 32 * e) / N;
      const int n = (lane + 32 * e) % N;
      float acc = f[e];
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(A[k * lda + i], B[k * ldb + n], acc);
      f[e] = acc;
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < E; ++e) C[((lane + 32 * e) / N) * ldc + (lane + 32 * e) % N] = f[e];
  }
};

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Sk, int causal, int q_offset,
                                        int k_offset) {
  return qi < Sq && kj < Sk && (!causal || q_offset + qi >= k_offset + kj);
}

// Dispatch on (dtype, head dim). float32 stops at D = 64: its D = 128 tiles
// would not fit in one block's shared memory.
#define HVD_DISPATCH(DTYPE, D, CALL)                                 \
  do {                                                               \
    if ((DTYPE) == DTYPE_BF16) {                                     \
      using T = bf16;                                                \
      switch (D) {                                                   \
        case 16: { constexpr int HD = 16; return CALL; }             \
        case 32: { constexpr int HD = 32; return CALL; }             \
        case 64: { constexpr int HD = 64; return CALL; }             \
        case 128: { constexpr int HD = 128; return CALL; }           \
        default: return cudaErrorInvalidValue;                       \
      }                                                              \
    } else if ((DTYPE) == DTYPE_F32) {                               \
      using T = float;                                               \
      switch (D) {                                                   \
        case 16: { constexpr int HD = 16; return CALL; }             \
        case 32: { constexpr int HD = 32; return CALL; }             \
        case 64: { constexpr int HD = 64; return CALL; }             \
        default: return cudaErrorInvalidValue;                       \
      }                                                              \
    }                                                                \
    return cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace
