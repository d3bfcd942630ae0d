// Flash attention backward in float32 at head dim 256 on Hopper's tensor
// cores: dQ (flash_dq_3xtf32_kernel) and dK/dV (flash_dkv_3xtf32_kernel).
// flash_attention.cu's launch_dq and launch_dkv call them for every float32
// call at D = 256, the instance of head dims 129 to 256
// (attention.py:padded_heads zero-pads to it).
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/attention.py:
//   flash_dq_3xtf32_kernel   <- _flash_dq_kernel (:198)
//   flash_dkv_3xtf32_kernel  <- _flash_dkv_kernel (:252)
//
// What bounds them, against the H100 SXM data-sheet peaks at its 700 W
// limit: at B*H = 128, S = 512 dQ needs 51.54 GFLOP of float32 products
// (3 products of 2 S^2 D a head) over 336 MB, dK/dV 68.72 GFLOP (4
// products) over 403 MB. On the FMA units (67 TFLOP/s) that is 0.77 and
// 1.03 ms, against 0.10 and 0.12 ms of bytes: bound by operations, as the
// first versions were, 33x and 47x over it.
//
// What the design does about it. Every product runs on the tensor cores in
// TF32 as three products (3xTF32): an fp32 value x is the pair hi + lo, hi =
// x rounded to TF32 and lo = x - hi, and A B is taken as A_lo B_hi +
// A_hi B_lo + A_hi B_hi (A_lo B_lo, below 2^-22 of A B, is left out). The
// tensor cores truncate every sum they form, so each product's sum over
// one 32-column box (scores) or one 64-row item (outputs) starts from zero
// and is added to the running sum in fp32, rounded to nearest. That holds
// float32's 1e-4 against the plain version, and its error against float64
// to that of the float32 plain version, where one TF32 product (10
// mantissa bits) would not. P and dS go through the same split, unrounded.
// Three TF32 products at 495 TFLOP/s make a least time of 0.31 (dQ) and
// 0.42 ms (dK/dV): the bound these kernels are held to.
//   - The products are mma.sync m16n8k8 TF32 with fragments read from the
//     tiles TMA landed in shared memory and split in registers (three
//     instructions a value). wgmma's TF32 form takes both operands from
//     shared memory K-major only (no transpose bit): its 3xTF32 would need a
//     hi and a lo copy of every operand, and transposed copies of K (dQ),
//     dO and Q (dK/dV), written to shared memory by the consumers first.
//     mma.sync reads any layout as it lies: the score products S = Q K^T,
//     dP = dO V^T (and their transposes in dK/dV) take their fragments by
//     ldmatrix (a TF32 fragment is an 8 x 4 word matrix), the output
//     products dS K, P^T dO, dS^T Q by 4-byte loads of the contraction's
//     rows, conflict-free in the 128-byte swizzle.
//   - Persistent blocks of two consumer warpgroups and a producer warpgroup
//     (one thread issues the TMA loads; setmaxnreg gives its registers to
//     the consumers), as in flash_attention_wide.cu. Operands arrive as
//     64-row x 32-column fp32 boxes (8 KB, 128-byte rows, the 128 B
//     swizzle) from 3-D tensor maps (D, S, BH): rows past S read as zeros.
//     The work tile's own pair of 64 x 256 tiles stays resident (dQ: Q and
//     dO; dK/dV: K and V, 128 KB) and the other side streams through a ring
//     of four 16 KB stages; the next work tile's resident pair loads once
//     the last score product of the current one is done.
//   - Warp w of warpgroup 0 and warp w of warpgroup 1 form a pair that owns
//     16 rows of the 64-row work tile. dQ, per 64-key tile: the warpgroup 0
//     warp computes S and P, the warpgroup 1 warp dP and, from P (handed
//     over in fp32 through the pair's 4 KB buffer, named barriers), dS =
//     P (dP - delta + g_lse), written back to the buffer in fragment order;
//     then the first adds dS K to dQ columns 0-127, the second to columns
//     128-255 (64 fp32 registers each), K streaming again as four 64-column
//     items. dK/dV, per 64-row Q tile: the warpgroup 0 warp computes S^T and
//     P^T and holds dV (all 256 columns, 128 registers), the warpgroup 1
//     warp dP^T, dS^T (P^T handed over as in dQ; each then reads its
//     product's A fragments from the pair's buffers) and dK: one column pass,
//     no score product computed twice, and dV and dK each fit one warp's
//     registers, where both would not.
//   - A fragment taken from an accumulator (P, dS, P^T, dS^T) keeps its
//     columns 2 t and 2 t + 1 and stands them for k = t and t + 4; the
//     other operand's rows are read in the same order, so no shuffle.
// Outputs leave from registers, 8 bytes a thread. Semantics as the other
// routes: causal masking on global positions q_offset + i >= k_offset + j,
// rows that see no key get dQ = 0, keys past Sk are not written, and the
// lse cotangent g_lse enters dS.

#include "flash_hopper.cuh"

namespace {

constexpr int X_D = 256;                           // the head dim
constexpr int X_BOX = 32;                          // fp32 columns of a box: 128-byte rows
constexpr int X_BOX_BYTES = SEQ_TILE * X_BOX * 4;  // 8 KB
constexpr int X_CHUNKS = X_D / X_BOX;              // boxes across D
constexpr int X_STAGE = 2 * X_BOX_BYTES;           // a ring stage: two boxes
constexpr int X_STAGES = 4;
constexpr int X_PAIRS = CONSUMER_WARPS / 2;  // warp pairs, 16 rows of the work tile each
constexpr int X_PAIR_ROWS = SEQ_TILE / X_PAIRS;
constexpr int X_ITEMS = 4;  // dQ's output items per key tile: 64 columns, two boxes, each

// Shared memory, byte offsets from a 1024-aligned base: the resident pair of
// 64 x 256 tiles (X_CHUNKS boxes each), the ring, two 16 x 64 fp32 exchange
// buffers per warp pair, then the ring's full/empty barriers and the
// resident tiles' full and empty barriers.
constexpr int X_RES = 2 * X_CHUNKS * X_BOX_BYTES;  // 128 KB
constexpr int X_RING = X_RES;
constexpr int X_XCH = X_RING + X_STAGES * X_STAGE;
constexpr int X_XCH_BYTES = X_PAIR_ROWS * SEQ_TILE * 4;
constexpr int X_BAR = X_XCH + 2 * X_PAIRS * X_XCH_BYTES;
constexpr int X_BYTES = X_BAR + (2 * X_STAGES + 2) * 8 + 1024;  // + alignment slack
static_assert(X_BYTES <= (int)SMEM_LIMIT, "3xTF32 tiles exceed shared memory");

// Named barriers of a pair's exchange (64 threads): XCH_FULL + pair once the
// warpgroup 0 warp has written P (P^T), XCH_BACK + pair once the warpgroup 1
// warp has written dS (dQ) or read P^T (dK/dV).
constexpr int XCH_FULL = 1;
constexpr int XCH_BACK = XCH_FULL + X_PAIRS;

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float4 lds_f4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
  return v;
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

// s (16 x 64, the accumulator layout: s[4 nt + x] is row g + 8 (x / 2),
// column 8 nt + 2 t + x % 2) += A B^T over one box's 32 columns: A is rows
// [a_row0, a_row0 + 16) of box a, B the 64 rows of box b. ldmatrix.x4 gives
// a0..a3 (rows + 0 / + 8, words [0, 4) / [4, 8) of the k-step) and b0, b1
// of two n-tiles; its eight row addresses of a matrix fall on distinct
// 16-byte chunks of the swizzle. The box's sum starts from zero and is
// added to s in fp32 (round to nearest): the tensor cores truncate each
// sum they form, so a running sum through them would lose about an ulp of
// itself at every product. NG groups of n-tiles, one after the other, keep
// the partial sum to 32 / NG registers (A's fragments are loaded again for
// each group), and KS_UNROLL of the four k-steps are unrolled: dK/dV takes
// NG = 2 and 2 (its scores and 128 accumulator registers leave no room for
// more loads in flight; ptxas spilled otherwise), dQ 1 and 4.
template <int NG, int KS_UNROLL>
__device__ __forceinline__ void scores_box(float (&s)[SEQ_TILE / 2], uint32_t a, int a_row0,
                                           uint32_t b, int lane) {
  constexpr int NP = SEQ_TILE / 16 / NG;  // n-tile pairs of a group
  const int r8 = lane & 7, m = lane >> 3;  // the row and matrix this lane addresses
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    float part[8 * NP];
#pragma unroll
    for (int i = 0; i < 8 * NP; ++i) part[i] = 0.f;
#pragma unroll KS_UNROLL
    for (int ks = 0; ks < X_BOX / 8; ++ks) {
      uint32_t x[4], ah[4], al[4];
      ldsm_x4(x, a + box_at(a_row0 + r8 + 8 * (m & 1), 8 * ks + 4 * (m >> 1)));
      split(x, ah, al);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t y[4], bh[4], bl[4];
        ldsm_x4(y, b + box_at(16 * (NP * grp + np) + 8 * (m >> 1) + r8, 8 * ks + 4 * (m & 1)));
        split(y, bh, bl);
        mma_3xtf32(part + 8 * np, ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(part + 8 * np + 4, ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8 * NP; ++i) s[8 * NP * grp + i] += part[i];
  }
}

// d (8 n-tiles) += A B over one output item: B is the item's two boxes (64
// rows, the contraction, by 64 columns), A (16 x 64) an accumulator-layout
// tile (P, dS, P^T or dS^T) whose fragment for k-step j, a0..a3, afrag(j)
// returns (from registers, or from a buffer in fragment order). A fragment
// takes the tile's columns 2 t and 2 t + 1 for k = t and t + 4, so b0 and b1
// are B's rows 8 j + 2 t and 8 j + 2 t + 1: with columns 8 nt + g they fall
// on 32 distinct banks. The item's sum starts from zero and is added to d
// in fp32, in NG groups of n-tiles as in scores_box; AFrag::UNROLL of the
// eight k-steps are unrolled.
template <int NG, typename AFrag>
__device__ __forceinline__ void product_item(float* d, uint32_t tile, AFrag afrag, int lane) {
  constexpr int NT = 8 / NG;  // n-tiles of a group
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    float part[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) part[i] = 0.f;
#pragma unroll AFrag::UNROLL
    for (int j = 0; j < SEQ_TILE / 8; ++j) {
      const float4 f = afrag(j);
      const uint32_t x[4] = {__float_as_uint(f.x), __float_as_uint(f.y), __float_as_uint(f.z),
                             __float_as_uint(f.w)};
      uint32_t ah[4], al[4];
      split(x, ah, al);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = NT * grp + nt;
        const uint32_t box = tile + (n >> 2) * X_BOX_BYTES;
        const int col = 8 * (n & 3) + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(lds_u32(box + box_at(8 * j + 2 * t, col)), bh0, bl0);
        split(lds_u32(box + box_at(8 * j + 2 * t + 1, col)), bh1, bl1);
        mma_3xtf32(part + 4 * nt, ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) d[4 * NT * grp + i] += part[i];
  }
}

// The A fragments of product_item from an accumulator-layout tile in
// registers (every k-step unrolled, so the tile stays in registers), and
// from a buffer in fragment order (float4 j * 32 + lane; J_UNROLL k-steps
// unrolled).
struct RegFrag {
  static constexpr int UNROLL = SEQ_TILE / 8;
  const float (&a)[SEQ_TILE / 2];
  __device__ __forceinline__ float4 operator()(int j) const {
    return make_float4(a[4 * j], a[4 * j + 2], a[4 * j + 1], a[4 * j + 3]);
  }
};
template <int J_UNROLL>
struct SmemFrag {
  static constexpr int UNROLL = J_UNROLL;
  const float4* a;
  int lane;
  __device__ __forceinline__ float4 operator()(int j) const { return lds_f4(a + j * 32 + lane); }
};

// Rows row, row + 8 of a 16 x W accumulator, times mul, to columns
// [col0, col0 + W) of out (rows past nrows not written), 8 bytes a thread.
template <int W>
__device__ __forceinline__ void store_acc(float* out, const float (&acc)[W / 2], float mul,
                                          int row, int nrows, int col0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= nrows) continue;
    float* o = out + (size_t)(row + 8 * h) * X_D + col0 + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) =
          make_float2(mul * acc[4 * nt + 2 * h], mul * acc[4 * nt + 2 * h + 1]);
  }
}

// Shared memory of a block: the ring and the resident tiles' barriers, set
// up before the block syncs.
struct XSmem {
  uint32_t base, res_full, res_empty;
  unsigned char* smem;  // base, generic
  Ring<X_STAGE> ring;
};

__device__ __forceinline__ XSmem x_smem(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t res_full = base + X_BAR + 16 * X_STAGES;
  const XSmem x{base, res_full, res_full + 8, smem_raw + (base - raw),
                make_ring<X_STAGE>(base + X_RING, X_BAR - X_RING, X_STAGES)};
  if (threadIdx.x == 0) {
    mbar_init(x.res_full, 1);
    mbar_init(x.res_empty, CONSUMER_WARPS);
    mbar_fence_init();
  }
  __syncthreads();
  return x;
}

// The producer's load of a work tile's resident pair (boxes of a, then of b,
// rows row0 of head bh), once the consumers have released the last one.
__device__ __forceinline__ void load_resident(const XSmem& x, int n, const CUtensorMap* a,
                                              const CUtensorMap* b, int row0, int bh) {
  mbar_wait(x.res_empty, (n & 1) ^ 1);
  mbar_arrive_expect_tx(x.res_full, X_RES);
  for (int c = 0; c < X_CHUNKS; ++c) {
    tma_load_3d(x.base + c * X_BOX_BYTES, a, x.res_full, X_BOX * c, row0, bh);
    tma_load_3d(x.base + (X_CHUNKS + c) * X_BOX_BYTES, b, x.res_full, X_BOX * c, row0, bh);
  }
}

// The producer's item of two boxes: columns col_a of a and col_b of b, rows
// row0 of head bh.
__device__ __forceinline__ void load_item(const XSmem& x, int it, const CUtensorMap* a, int col_a,
                                          const CUtensorMap* b, int col_b, int row0, int bh) {
  const uint32_t tile = x.ring.fill(it, X_STAGE);
  tma_load_3d(tile, a, x.ring.bar(it), col_a, row0, bh);
  tma_load_3d(tile + X_BOX_BYTES, b, x.ring.bar(it), col_b, row0, bh);
}

// A consumer warp is done with the resident pair.
__device__ __forceinline__ void release_resident(const XSmem& x, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(x.res_empty);
}

// dQ output item u (of X_ITEMS per key tile): the warpgroup that adds it,
// u % 2, and its first column: warpgroup 0 holds columns 0-127, 1 128-255,
// and the items alternate so that both work at once.
__host__ __device__ constexpr int dq_item_col(int u) { return 128 * (u & 1) + 64 * (u >> 1); }

// dQ, persistent: a grid of one block per SM walks the work tiles (bh, 64
// Q rows) and loops over the key tiles their rows can see. dq = scale *
// sum_j dS_j K_j, [BH, Sq, 256] fp32.
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dq_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dq,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ glse, int BH, int Sq, int Sk, float scale,
                       int causal, int q_offset, int k_offset) {
  extern __shared__ unsigned char smem_raw[];
  const XSmem x = x_smem(smem_raw);
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int nwork = BH * qtiles;  // work tile w: Q tile w % qtiles of head w / qtiles
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile Q and dO; per key tile its score
    // items (K and V boxes of 32 columns), then its output items (K, 64
    // columns).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int q0 = w % qtiles * SEQ_TILE, bh = w / qtiles;
        load_resident(x, n, &tm_q, &tm_do, q0, bh);
        const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * SEQ_TILE;
          for (int c = 0; c < X_CHUNKS; ++c, ++it)
            load_item(x, it, &tm_k, X_BOX * c, &tm_v, X_BOX * c, k0, bh);
          for (int u = 0; u < X_ITEMS; ++u, ++it)
            load_item(x, it, &tm_k, dq_item_col(u), &tm_k, dq_item_col(u) + X_BOX, k0, bh);
        }
      }
    }
  } else {
    // Consumer warp: pair p = warp % 4 owns rows [16 p, 16 p + 16) of the
    // work tile; warpgroup 0 computes S and P, warpgroup 1 dP and dS.
    reg_alloc<CONSUMER_REGS>();
    const int pair = (threadIdx.x / 32) % X_PAIRS;
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int r = X_PAIR_ROWS * pair + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    float* const xch = reinterpret_cast<float*>(x.smem + X_XCH + 2 * pair * X_XCH_BYTES);
    const uint32_t res = x.base + wg * X_CHUNKS * X_BOX_BYTES;  // Q or dO
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int q0 = w % qtiles * SEQ_TILE, bh = w / qtiles;
      const int row0 = q0 + r;  // and row0 + 8
      const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
      // This thread's two rows: lse log2(e) for warpgroup 0, g_lse - delta
      // for warpgroup 1. Rows past Sq get lse = LSE_MASKED: their P is 0.
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
      float acc[X_D / 4];  // dQ: the pair's 16 rows by this warpgroup's 128 columns
#pragma unroll
      for (int i = 0; i < X_D / 4; ++i) acc[i] = 0.f;
      mbar_wait(x.res_full, n & 1);
      if (nk == 0) release_resident(x, lane);

      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * SEQ_TILE;
        // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), 16 x 64.
        float s[SEQ_TILE / 2];
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
        for (int c = 0; c < X_CHUNKS; ++c, ++it) {
          x.ring.wait(it);
          scores_box<1, 4>(s, res + c * X_BOX_BYTES, X_PAIR_ROWS * pair,
                           x.ring.tile(it) + wg * X_BOX_BYTES, lane);
          x.ring.release(it, lane);
        }
        if (kt == nk - 1) release_resident(x, lane);

        // P to the partner in fp32 (thread lane's element i at i 32 + lane),
        // which forms dS = P (dP + g_lse - delta) and writes it back in
        // fragment order. Keys past Sk read zero rows of K but get P = 0.
        if (wg == 0) {
          const bool mask =
              k0 + SEQ_TILE > Sk || (causal && q_offset + q0 < k_offset + k0 + SEQ_TILE - 1);
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) {
            const int kj = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
            const int h = (i >> 1) & 1;
            float pv = exp2f(fmaf(s[i], sl2, -rv[h]));
            if (mask && (kj >= Sk || (causal && q_offset + row0 + 8 * h < k_offset + kj)))
              pv = 0.f;
            xch[i * 32 + lane] = pv;
          }
          __threadfence_block();
          named_arrive(XCH_FULL + pair, 64);
          named_sync(XCH_BACK + pair, 64);
        } else {
          named_sync(XCH_FULL + pair, 64);
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i)
            s[i] = xch[i * 32 + lane] * (s[i] + rv[(i >> 1) & 1]);
          __syncwarp();  // every lane has read P before dS overwrites it
#pragma unroll
          for (int j = 0; j < SEQ_TILE / 8; ++j)
            reinterpret_cast<float4*>(xch)[j * 32 + lane] =
                make_float4(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
          __threadfence_block();
          named_arrive(XCH_BACK + pair, 64);
        }

        // dQ += dS K over this warpgroup's output items (dS from the buffer
        // for warpgroup 0, from its registers for warpgroup 1); the other
        // warpgroup's items are waited for and released.
#pragma unroll
        for (int u = 0; u < X_ITEMS; ++u, ++it) {
          x.ring.wait(it);
          if ((u & 1) == wg) {
            if (wg == 0)
              product_item<1>(acc + 32 * (u >> 1), x.ring.tile(it),
                              SmemFrag<8>{reinterpret_cast<const float4*>(xch), lane}, lane);
            else
              product_item<1>(acc + 32 * (u >> 1), x.ring.tile(it), RegFrag{s}, lane);
          }
          x.ring.release(it, lane);
        }
      }
      store_acc<X_D / 2>(dq + (size_t)bh * Sq * X_D, acc, scale, row0, Sq, 128 * wg, lane);
    }
  }
}

// dK/dV, persistent: a grid of one block per SM walks the work tiles (bh,
// 64 keys) and loops over the Q tiles that can see the keys. dV = sum_i
// P_ij^T dO_i (warpgroup 0), dK = scale * sum_i dS_ij^T Q_i (warpgroup 1),
// [BH, Sk, 256] fp32.
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dkv_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dk,
                        float* __restrict__ dv, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ glse, int BH,
                        int Sq, int Sk, float scale, int causal, int q_offset, int k_offset) {
  extern __shared__ unsigned char smem_raw[];
  const XSmem x = x_smem(smem_raw);
  const int ktiles = (Sk + SEQ_TILE - 1) / SEQ_TILE;
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int nwork = BH * ktiles;  // work tile w: key tile w % ktiles of head w / ktiles
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile K and V; per Q tile its score
    // items (Q and dO boxes of 32 columns), then its output items (dO and Q
    // by turns, 64 columns each).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int k0 = w % ktiles * SEQ_TILE, bh = w / ktiles;
        load_resident(x, n, &tm_k, &tm_v, k0, bh);
        for (int qt = first_query_tile(k0, causal, q_offset, k_offset); qt < qtiles; ++qt) {
          const int q0 = qt * SEQ_TILE;
          for (int c = 0; c < X_CHUNKS; ++c, ++it)
            load_item(x, it, &tm_q, X_BOX * c, &tm_do, X_BOX * c, q0, bh);
          for (int u = 0; u < 2 * X_ITEMS; ++u, ++it) {
            const CUtensorMap* m = (u & 1) ? &tm_q : &tm_do;
            const int col0 = 64 * (u >> 1);
            load_item(x, it, m, col0, m, col0 + X_BOX, q0, bh);
          }
        }
      }
    }
  } else {
    // Consumer warp: pair p = warp % 4 owns keys [16 p, 16 p + 16) of the
    // work tile; warpgroup 0 computes S^T, P^T and dV, warpgroup 1 dP^T,
    // dS^T and dK.
    reg_alloc<CONSUMER_REGS>();
    const int pair = (threadIdx.x / 32) % X_PAIRS;
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int r = X_PAIR_ROWS * pair + (lane >> 2);  // this thread's keys r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    float* const xch = reinterpret_cast<float*>(x.smem + X_XCH + 2 * pair * X_XCH_BYTES);
    const uint32_t res = x.base + wg * X_CHUNKS * X_BOX_BYTES;  // K or V
    int it = 0, n = 0;
    int pt = 0;  // Q tiles so far: P^T hand-offs
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int k0 = w % ktiles * SEQ_TILE, bh = w / ktiles;
      const int key0 = k0 + r;  // and key0 + 8
      const int qt0 = first_query_tile(k0, causal, q_offset, k_offset);
      float acc[X_D / 2];  // dV or dK: the pair's 16 keys by 256 columns
#pragma unroll
      for (int i = 0; i < X_D / 2; ++i) acc[i] = 0.f;
      mbar_wait(x.res_full, n & 1);
      if (qt0 >= qtiles) release_resident(x, lane);

      for (int qt = qt0; qt < qtiles; ++qt, ++pt) {
        const int q0 = qt * SEQ_TILE;
        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 16 x 64.
        float s[SEQ_TILE / 2];
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
        for (int c = 0; c < X_CHUNKS; ++c, ++it) {
          x.ring.wait(it);
          scores_box<2, 2>(s, res + c * X_BOX_BYTES, X_PAIR_ROWS * pair,
                           x.ring.tile(it) + wg * X_BOX_BYTES, lane);
          x.ring.release(it, lane);
        }
        if (qt == qtiles - 1) release_resident(x, lane);

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

        // P^T to the partner in fp32, in fragment order (float4 j * 32 +
        // lane: a0..a3 of k-step j), which forms dS^T = P^T (dP^T + g_lse -
        // delta) into its own buffer in the same order; each warp then
        // reads its product's A fragments there, so that its scores are
        // not live through the products. Keys past Sk are never written, so
        // they need no mask.
        float4* const pt4 = reinterpret_cast<float4*>(xch);
        float4* const dst4 = reinterpret_cast<float4*>(xch) + SEQ_TILE / 8 * 32;
        if (wg == 0) {
          const bool mask = causal && q_offset + q0 < k_offset + k0 + SEQ_TILE - 1;
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) {
            const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
            float pv = exp2f(fmaf(s[i], sl2, -rv[2 * (i >> 2) + (i & 1)]));
            if (mask && q_offset + q0 + c < k_offset + key0 + 8 * ((i >> 1) & 1)) pv = 0.f;
            s[i] = pv;
          }
          if (pt > 0) named_sync(XCH_BACK + pair, 64);  // the last P^T has been read
#pragma unroll
          for (int j = 0; j < SEQ_TILE / 8; ++j)
            pt4[j * 32 + lane] = make_float4(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
          __threadfence_block();
          named_arrive(XCH_FULL + pair, 64);
        } else {
          named_sync(XCH_FULL + pair, 64);
#pragma unroll
          for (int j = 0; j < SEQ_TILE / 8; ++j) {
            const float4 p = pt4[j * 32 + lane];
            dst4[j * 32 + lane] = make_float4(
                p.x * (s[4 * j] + rv[2 * j]), p.y * (s[4 * j + 2] + rv[2 * j]),
                p.z * (s[4 * j + 1] + rv[2 * j + 1]), p.w * (s[4 * j + 3] + rv[2 * j + 1]));
          }
          __threadfence_block();
          named_arrive(XCH_BACK + pair, 64);
        }

        // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1) over
        // this warpgroup's output items; the other's are waited for and
        // released.
#pragma unroll
        for (int u = 0; u < 2 * X_ITEMS; ++u, ++it) {
          x.ring.wait(it);
          if ((u & 1) == wg)
            product_item<2>(acc + 32 * (u >> 1), x.ring.tile(it),
                            SmemFrag<2>{wg == 0 ? pt4 : dst4, lane}, lane);
          x.ring.release(it, lane);
        }
      }
      store_acc<X_D>((wg == 0 ? dv : dk) + (size_t)bh * Sk * X_D, acc, wg == 0 ? 1.f : scale,
                     key0, Sk, 0, lane);
    }
    // Take the partner's arrival after its last read of P^T.
    if (wg == 0 && pt > 0) named_sync(XCH_BACK + pair, 64);
  }
}

// The tensor map of a contiguous [BH, S, 256] fp32 tensor in 64-row x
// 32-column boxes (128-byte rows, the 128 B swizzle); rows past S read as
// zeros.
int x_map(CUtensorMap* map, const void* base, int S, int BH) {
  const cuuint64_t dims[3] = {(cuuint64_t)X_D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)X_D * 4, (cuuint64_t)S * X_D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)X_BOX, (cuuint32_t)SEQ_TILE, 1};
  return make_map<float>(map, base, 3, dims, strides, box, X_BOX * 4);
}

// The four operands' tensor maps and a persistent grid of min(nwork, SMs)
// blocks.
int x_setup(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
            int BH, int Sq, int Sk, int nwork, dim3* grid) {
  int err, sms = 0;
  if ((err = x_map(&m[0], q, Sq, BH)) || (err = x_map(&m[1], k, Sk, BH)) ||
      (err = x_map(&m[2], v, Sk, BH)) || (err = x_map(&m[3], dout, Sq, BH)) ||
      (err = sm_count(&sms)))
    return err;
  *grid = dim3(nwork < sms ? nwork : sms);
  return 0;
}

}  // namespace

// The launchers flash_attention.cu calls for float32 at D = 256: on the
// given stream, returning the cudaError_t of the launch (or
// HVD_ERR_TENSOR_MAP + the CUresult).
int launch_dq_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse, void* dq, int BH,
                     int Sq, int Sk, float scale, int causal, int qo, int ko,
                     cudaStream_t stream) {
  if (Sq == 0 || BH == 0) return cudaSuccess;
  if (Sk == 0)  // no key: dQ is 0 (and a tensor map cannot have an empty dim)
    return cudaMemsetAsync(dq, 0, (size_t)BH * Sq * X_D * sizeof(float), stream);
  CUtensorMap m[4];
  dim3 grid;
  const int err = x_setup(m, q, k, v, dout, BH, Sq, Sk, BH * ((Sq + SEQ_TILE - 1) / SEQ_TILE),
                          &grid);
  if (err) return err;
  return launch(flash_dq_3xtf32_kernel, grid, SM90_THREADS, X_BYTES, stream, m[0], m[1], m[2],
                m[3], (float*)dq, (const float*)lse, (const float*)delta, (const float*)glse, BH,
                Sq, Sk, scale, causal, qo, ko);
}

int launch_dkv_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                      int BH, int Sq, int Sk, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  if (Sk == 0 || BH == 0) return cudaSuccess;
  if (Sq == 0) {  // no query: dK and dV are 0
    const size_t bytes = (size_t)BH * Sk * X_D * sizeof(float);
    const cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(dv, 0, bytes, stream);
  }
  CUtensorMap m[4];
  dim3 grid;
  const int err = x_setup(m, q, k, v, dout, BH, Sq, Sk, BH * ((Sk + SEQ_TILE - 1) / SEQ_TILE),
                          &grid);
  if (err) return err;
  return launch(flash_dkv_3xtf32_kernel, grid, SM90_THREADS, X_BYTES, stream, m[0], m[1], m[2],
                m[3], (float*)dk, (float*)dv, (const float*)lse, (const float*)delta,
                (const float*)glse, BH, Sq, Sk, scale, causal, qo, ko);
}
