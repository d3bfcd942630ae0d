// What the port's CUDA sources share at the bottom: the element types, the
// masking sentinels, the shared-memory limit, the dtype codes of the C
// interface, and the (dtype, head dim) dispatch of the C entry points.
//
// Everything sits in an anonymous namespace: each translation unit gets its
// own copy, so the sources link into one library without clashes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float NEG_INF = -1e30f;
constexpr float LSE_MASKED = 1e30f;
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

// dtype codes shared with horovod_tpu_torch/ops/_kernels.py.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F16 = 2;

// Dispatch on (dtype, head dim): bf16, float16 and float32 at D = 16, 32,
// 64 and 128; HVD_DISPATCH_WIDE (the multi-tile kernels) also at D = 256.
// The float32 kernels (3xTF32) have no D = 16 instance (their launch
// refuses it; the wrapper zero-pads D = 16 to 32).
#define HVD_CASES_D(CALL)                                            \
  case 16: { constexpr int HD = 16; return CALL; }                   \
  case 32: { constexpr int HD = 32; return CALL; }                   \
  case 64: { constexpr int HD = 64; return CALL; }                   \
  case 128: { constexpr int HD = 128; return CALL; }
#define HVD_SWITCH_D(D, CALL)                                        \
  switch (D) {                                                       \
    HVD_CASES_D(CALL)                                                \
    default: return cudaErrorInvalidValue;                           \
  }
#define HVD_SWITCH_D_WIDE(D, CALL)                                   \
  switch (D) {                                                       \
    HVD_CASES_D(CALL)                                                \
    case 256: { constexpr int HD = 256; return CALL; }               \
    default: return cudaErrorInvalidValue;                           \
  }
#define HVD_DISPATCH_BY(SWITCH, DTYPE, D, CALL)                      \
  do {                                                               \
    if ((DTYPE) == DTYPE_BF16) {                                     \
      using T = bf16;                                                \
      SWITCH(D, CALL)                                                \
    } else if ((DTYPE) == DTYPE_F16) {                               \
      using T = f16;                                                 \
      SWITCH(D, CALL)                                                \
    } else if ((DTYPE) == DTYPE_F32) {                               \
      using T = float;                                               \
      SWITCH(D, CALL)                                                \
    }                                                                \
    return cudaErrorInvalidValue;                                    \
  } while (0)
#define HVD_DISPATCH(DTYPE, D, CALL) HVD_DISPATCH_BY(HVD_SWITCH_D, DTYPE, D, CALL)
#define HVD_DISPATCH_WIDE(DTYPE, D, CALL) HVD_DISPATCH_BY(HVD_SWITCH_D_WIDE, DTYPE, D, CALL)

}  // namespace
