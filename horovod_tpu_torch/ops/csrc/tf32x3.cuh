// What the float32 kernels that multiply on Hopper's tensor cores in 3xTF32
// share (flash_attention_3xtf32.cu, conv1x1_dw.cu): the hi/lo split of an
// fp32 value, mma.sync m16n8k8 TF32 and its 3xTF32 form, the 4-byte shared
// load, and where TMA's 128 B swizzle puts an fp32 element of a box of
// 128-byte rows (32 fp32 columns).
//
// Everything sits in an anonymous namespace, as in flash_common.cuh.

#pragma once

#include <stdint.h>

namespace {

constexpr int X_BOX = 32;  // fp32 columns of a box: 128-byte rows

// x as the TF32 pair hi + lo, as fp32 bit patterns: hi is x rounded to TF32
// (half an ulp of TF32 added to the bits, the low 13 bits cleared: to
// nearest, ties away from zero), lo = x - hi, exact in fp32, which the
// tensor cores read as TF32 (its low 13 bits dropped: at most 2^-21 of x).
// Three integer and float instructions: cvt.rna.tf32.f32 for hi and lo
// measured slower on the H100 for the same accuracy (PERF.md).
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}
template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// d[0..4) += A B, one m16n8k8 TF32 product (A: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B: b0 (k = t, n = g), b1 (k = t + 4,
// n = g); D: (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8, 2 t + 1), for
// lane 4 g + t).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Byte offset of fp32 element (row, col) in a box of 128-byte rows that
// starts on a 1024-byte boundary, where TMA's 128 B swizzle puts it: the
// 16-byte chunk index XORs with row % 8.
__device__ __forceinline__ uint32_t box_at(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4);
}

}  // namespace
