// Hopper (sm_90a) device helpers shared by the port's CUDA kernels: the
// wgmma shared-memory descriptor and the bf16 wgmma.mma_async wrappers (A
// from shared memory or from registers), the warpgroup fence, commit and
// wait, mbarrier init / arrive / expect-tx / parity wait (with a timeout that
// ends the kernel with an error), the TMA tile load and store
// (cp.async.bulk.tensor), register rebalancing (setmaxnreg), and
// on the host the encoding of a bf16 CUtensorMap (any rank; a [BH, S, D]
// tensor in the tile format below), with no link against libcuda (its
// entry point comes through the runtime).
//
// The layout every helper agrees on (TileFormat below): a tile of R rows
// and D bf16 columns is stored as D / CB boxes of CB = min(D, 64) columns,
// box after box, each box R rows of CB * 2 bytes with the hardware swizzle
// of that row width (128, 64 or 32 bytes). TMA writes it in this form and
// wgmma reads it both ways: K-major (contraction over the D columns, as
// for Q and K in S = Q K^T) and MN-major (contraction over the rows, as for
// V in O = P V). Tiles start on 1024-byte boundaries, so every descriptor
// has base offset 0.
//
// Everything sits in an anonymous namespace, as in flash_common.cuh.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace {

// Error codes above this one are HVD_ERR_TENSOR_MAP + the CUresult of
// cuTensorMapEncodeTiled (hvd_error_string names them).
constexpr int HVD_ERR_TENSOR_MAP = 10000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (LBO, SBO), swizzle of 128, 64 or 32 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The smem tile format of the header note, for D bf16 columns.
template <int D>
struct TileFormat {
  static constexpr int CB = D < 64 ? D : 64;   // columns of one box
  static constexpr int NB = D / CB;            // boxes
  static constexpr int ROW_BYTES = CB * 2;     // = the swizzle width
  static constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // one 8-row swizzle atom
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dims 16, 32, 64, 128");

  // K-major operand: rows [row0, row0 + M or N) of a tile of R rows, columns
  // [16 kk, 16 kk + 16). Stepping along K moves the start inside the swizzle
  // atom; the hardware applies the swizzle to the address it forms. SBO
  // steps from one 8-row group to the next; LBO is unused in this layout.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int R, int row0, int kk) {
    const uint32_t addr = tile + (uint32_t)((kk * 16 / CB) * R * ROW_BYTES + row0 * ROW_BYTES +
                                            (kk * 16 % CB) * 2);
    return wgmma_desc(addr, 16, GROUP_BYTES, ROW_BYTES);
  }

  // Byte offset of element (r, c) in a tile of R rows, swizzled as TMA
  // swizzles it: the 16-byte chunk index XORs with address bits 7 and up.
  static __device__ __forceinline__ uint32_t offset(int R, int r, int c) {
    const uint32_t a = (uint32_t)(r * ROW_BYTES + (c % CB) * 2);
    return (uint32_t)((c / CB) * R * ROW_BYTES) + (a ^ (((a >> 7) & (ROW_BYTES / 16 - 1)) << 4));
  }

  // MN-major operand over all D columns: rows [16 kk, 16 kk + 16) of a tile
  // of R rows are the contraction. LBO steps from box to box along D, SBO
  // from one 8-row group to the next.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int R, int kk) {
    const uint32_t addr = tile + (uint32_t)(kk * 16 * ROW_BYTES);
    return wgmma_desc(addr, (uint32_t)(R * ROW_BYTES), GROUP_BYTES, ROW_BYTES);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: reads after a
// wgmma_wait must not be hoisted above it, writes before a wgmma must not
// sink below it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments held in registers (K steps of four words).
template <int KS>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 operands, fp32 accumulator in
// registers: d[N / 2] per thread, in the wgmma accumulator layout (warp w of
// the warpgroup holds rows 16 w + lane / 4 and + 8; element i is column
// 8 (i / 4) + 2 (lane % 4) + (i % 2) of the second row when (i / 2) % 2).
//   ss: D += A B, A and B from shared memory (descriptors a, b).
//   ss_init: D = A B; D is only written, so the compiler does not treat its
//       earlier contents as an input of the product.
//   rs: D += A B, A from registers: four 32-bit words of bf16 pairs in the
//       mma A layout, which is the accumulator layout of 16 columns.
// TRANS_B = 0: B K-major; 1: B MN-major. TRANS_A (ss only; the rs A is
// always the register layout) = 0: A K-major; 1: A MN-major, with the
// descriptor of TileFormat::mnmajor, as for B: the 64 rows of A are the
// columns of one 64-column box. The kernels use ss and ss_init at N = 16,
// 32, 64, 128 and rs at N = 16, 32, 64, 128.
template <int N>
struct Wgmma;

// The accumulator's asm operands d[i .. i + n) with constraint C ("+f": read
// and written; "=f": written only), and the register list "%0, ..., %(n - 1)"
// of the first n operands.
#define HVD_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define HVD_D8(C, i) HVD_D4(C, i), HVD_D4(C, i + 4)
#define HVD_D16(C, i) HVD_D8(C, i), HVD_D8(C, i + 8)
#define HVD_D32(C, i) HVD_D16(C, i), HVD_D16(C, i + 16)
#define HVD_D64(C, i) HVD_D32(C, i), HVD_D32(C, i + 32)
#define HVD_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HVD_REGS16 HVD_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HVD_REGS32 \
  HVD_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HVD_REGS64                                                                              \
  HVD_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
             "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// The members of Wgmma<N>, whose accumulator is N / 2 floats: REGS and DOPS
// are its register list and operand macro from above, and "%" I<k> names
// operand N / 2 + k, the k-th after the accumulator. SS: a, b, scale-d
// (0: D = A B; 1: D += A B), trans-b, trans-a. RS: four A words, b,
// scale-d, trans-b.
#define HVD_WGMMA_SS(NAME, C, SCALE, N, REGS, DOPS, I0, I1, I2, I3, I4)                 \
  template <int TRANS_B, int TRANS_A = 0>                                                \
  static __device__ __forceinline__ void NAME(float (&d)[N / 2], uint64_t a, uint64_t b) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" I2 ", 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS         \
                 "}, %" I0 ", %" I1 ", p, 1, 1, %" I4 ", %" I3 ";\n}\n"                   \
                 : DOPS(C, 0)                                                            \
                 : "l"(a), "l"(b), "r"(SCALE), "n"(TRANS_B), "n"(TRANS_A));              \
  }
#define HVD_WGMMA_RS(N, REGS, DOPS, I0, I1, I2, I3, I4, I5, I6)                              \
  template <int TRANS_B>                                                                     \
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],       \
                                            uint64_t b) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" I5 ", 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS             \
                 "}, {%" I0 ", %" I1 ", %" I2 ", %" I3 "}, %" I4 ", p, 1, 1, %" I6 ";\n}\n"   \
                 : DOPS("+f", 0)                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B)); \
  }

template <>
struct Wgmma<16> {
  HVD_WGMMA_SS(ss, "+f", 1, 16, HVD_REGS8, HVD_D8, "8", "9", "10", "11", "12")
  HVD_WGMMA_SS(ss_init, "=f", 0, 16, HVD_REGS8, HVD_D8, "8", "9", "10", "11", "12")
  HVD_WGMMA_RS(16, HVD_REGS8, HVD_D8, "8", "9", "10", "11", "12", "13", "14")
};
template <>
struct Wgmma<32> {
  HVD_WGMMA_SS(ss, "+f", 1, 32, HVD_REGS16, HVD_D16, "16", "17", "18", "19", "20")
  HVD_WGMMA_SS(ss_init, "=f", 0, 32, HVD_REGS16, HVD_D16, "16", "17", "18", "19", "20")
  HVD_WGMMA_RS(32, HVD_REGS16, HVD_D16, "16", "17", "18", "19", "20", "21", "22")
};
template <>
struct Wgmma<64> {
  HVD_WGMMA_SS(ss, "+f", 1, 64, HVD_REGS32, HVD_D32, "32", "33", "34", "35", "36")
  HVD_WGMMA_SS(ss_init, "=f", 0, 64, HVD_REGS32, HVD_D32, "32", "33", "34", "35", "36")
  HVD_WGMMA_RS(64, HVD_REGS32, HVD_D32, "32", "33", "34", "35", "36", "37", "38")
};
template <>
struct Wgmma<128> {
  HVD_WGMMA_SS(ss, "+f", 1, 128, HVD_REGS64, HVD_D64, "64", "65", "66", "67", "68")
  HVD_WGMMA_SS(ss_init, "=f", 0, 128, HVD_REGS64, HVD_D64, "64", "65", "66", "67", "68")
  HVD_WGMMA_RS(128, HVD_REGS64, HVD_D64, "64", "65", "66", "67", "68", "69", "70")
};

#undef HVD_WGMMA_RS
#undef HVD_WGMMA_SS
#undef HVD_REGS64
#undef HVD_REGS32
#undef HVD_REGS16
#undef HVD_REGS8
#undef HVD_D64
#undef HVD_D32
#undef HVD_D16
#undef HVD_D8
#undef HVD_D4

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the inits visible to the async proxy (TMA); then a __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A phase that has not completed within this time never will: a wrong
// expect-tx byte count, a parity slip or a TMA that faulted. A wait of a
// working kernel lasts microseconds.
constexpr uint64_t MBAR_TIMEOUT_NS = 2000000000ull;

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts MBAR_TIMEOUT_NS stores to address 0, so the kernel ends with
// cudaErrorIllegalAddress, which the next launch or synchronisation reports,
// instead of spinning forever. Not __trap(): on this path a trap makes ptxas
// allocate the whole kernel within the entry register count, ignoring the
// budget setmaxnreg gives the consumers.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - start > MBAR_TIMEOUT_NS)
      asm volatile("st.global.u32 [%0], %1;\n" ::"l"(0ull), "r"(0u) : "memory");
}

// TMA: copy the box at coordinates (c0, c1, c2) of a 3-D tensor map into
// shared memory at dst; completion adds the bytes to barrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 2-D tensor map (c0, c1) and a 4-D one (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: copy shared memory at src into the box at coordinates (c0, c1, c2)
// of a 3-D tensor map (elements outside the tensor are not written), as one
// bulk async-group; bulk_commit closes the group, bulk_wait_read<N> waits
// until at most N groups still read shared memory.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_bf16(uint32_t addr, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr),
               "h"(*reinterpret_cast<const unsigned short*>(&h))
               : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register rebalancing between warpgroups (every warp of the warpgroup runs
// it; the kernel's roles must split in one if/else that never rejoins).
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's
// entry-point query (no -lcuda); null where libcuda lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor map of a bf16 tensor of rank `rank` (2 to 5): dims[0] is the
// contiguous one, strides[i] the byte stride of dims[i + 1], box the box
// dims; row_bytes (box[0] * 2 = 128, 64 or 32) picks the swizzle. Elements
// outside the dims read as zeros. Returns 0 or HVD_ERR_TENSOR_MAP + the
// CUresult.
inline int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box, int row_bytes) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return HVD_ERR_TENSOR_MAP + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : HVD_ERR_TENSOR_MAP + (int)r;
}

// The tensor map of a contiguous [BH, S, D] bf16 tensor whose box is one
// TileFormat<D> box: CB columns by box_rows rows of one bh. Rows past S read
// as zeros, never as the next head's rows.
template <int D>
int make_tile_map(CUtensorMap* map, const void* base, int S, int BH, int box_rows) {
  using F = TileFormat<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)F::CB, (cuuint32_t)box_rows, 1};
  return make_map(map, base, 3, dims, strides, box, F::ROW_BYTES);
}

}  // namespace
