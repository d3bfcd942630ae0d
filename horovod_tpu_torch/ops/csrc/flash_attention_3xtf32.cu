// Flash attention in float32 on Hopper's tensor cores (3xTF32), every
// float32 call of the three routes: the forwards at head dims 32 to 256
// (flash_fwd_3xtf32_kernel<D>, the multi-tile route, and
// flash_fwd_single_3xtf32_kernel<D>, Sq and Sk at most 128), the backward
// at head dims 32 to 256: dQ (flash_dq_3xtf32_kernel<D>) and dK/dV
// (flash_dkv_3xtf32_kernel<D>), the fused single-tile backward at head dims
// 32 to 128 (flash_dqkv_3xtf32_kernel<D>, Sq and Sk at most 128), and the
// forward and backward at any head dim above 256
// (flash_fwd_wide_3xtf32_kernel, flash_dq_wide_3xtf32_kernel,
// flash_dkv_wide_3xtf32_kernel; D a multiple of 32).
// flash_attention.cu's launch_fwd, launch_dq and launch_dkv,
// flash_attention_single.cu's launch_fwd_single and launch_dqkv and
// flash_attention_wide.cu's float32 forward, dQ and dK/dV call them
// (attention.py:padded_heads zero-pads a head dim to the next instance,
// D = 16 to 32: a box row is 32 fp32 columns, and a wide D to a multiple
// of 32). The split, the mma.sync wrappers and the swizzle's address are
// in tf32x3.cuh.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/attention.py:
//   flash_fwd_3xtf32_kernel         <- _flash_fwd_kernel (:138)
//   flash_fwd_single_3xtf32_kernel  <- _flash_fwd_single_kernel (:310)
//   flash_dq_3xtf32_kernel          <- _flash_dq_kernel (:198)
//   flash_dkv_3xtf32_kernel         <- _flash_dkv_kernel (:252)
//   flash_dqkv_3xtf32_kernel        <- _flash_dqkv_fused_kernel (:343)
//   flash_fwd_wide_3xtf32_kernel    <- _flash_fwd_kernel (:138), D > 256
//   flash_dq_wide_3xtf32_kernel     <- _flash_dq_kernel (:198), D > 256
//   flash_dkv_wide_3xtf32_kernel    <- _flash_dkv_kernel (:252), D > 256
//
// What bounds them, against the H100 SXM data-sheet peaks at its 700 W
// limit: at B*H = 128, S = 512, D = 256 dQ needs 51.54 GFLOP of float32
// products (3 products of 2 S^2 D a head) over 336 MB, dK/dV 68.72 GFLOP (4
// products) over 403 MB, the forward 34.36 GFLOP (2 products) over 269 MB.
// On the FMA units (67 TFLOP/s) that is 0.77, 1.03 and 0.51 ms, against
// 0.10, 0.12 and 0.08 ms of bytes: bound by operations, as the first SIMT
// versions were, 33x, 47x and 36x over it. At D = 64 the same holds at a
// quarter of the operations (dQ 12.88, dK/dV 17.18 GFLOP). The single-tile
// forward at B*H = 1024, S = 128, D = 64 moves 134.7 MB (0.0402 ms) for
// 4.29 GFLOP, the fused backward there 236.5 MB (0.0706 ms) for 10.74 GFLOP
// (0.1603 ms on the FMA units).
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
// Three TF32 products at 495 TFLOP/s make a least time of 0.31 (dQ), 0.42
// (dK/dV) and 0.21 ms (the forward at D = 256), 0.078 and 0.104 ms (dQ,
// dK/dV at D = 64): the bound these kernels are held to; the single-tile
// forward stays bound by its bytes (0.0260 ms of operations), and so does
// the fused backward, near the ridge (0.0651 ms of operations). The wide
// route at B*H = 32, S = 512, D = 512: dQ 25.77 GFLOP over 168 MB, dK/dV
// 34.36 GFLOP over 201 MB, 0.1562 and 0.2082 ms in 3xTF32, the forward
// 17.18 GFLOP over 134 MB, 0.1041 ms.
//   - The products are mma.sync m16n8k8 TF32 with fragments read from the
//     tiles TMA landed in shared memory and split in registers (three
//     instructions a value). wgmma's TF32 form takes both operands from
//     shared memory K-major only (no transpose bit): its 3xTF32 would need a
//     hi and a lo copy of every operand, and transposed copies of K (dQ),
//     dO and Q (dK/dV) and V (forward), written to shared memory by the
//     consumers first. mma.sync reads any layout as it lies: the score
//     products S = Q K^T, dP = dO V^T (and their transposes in dK/dV) take
//     their fragments by ldmatrix (a TF32 fragment is an 8 x 4 word
//     matrix), the output products P V, dS K, P^T dO, dS^T Q by 4-byte
//     loads of the contraction's rows, conflict-free in the 128-byte
//     swizzle.
//   - Persistent blocks of two consumer warpgroups and a producer warpgroup
//     (one thread issues the TMA loads; setmaxnreg gives its registers to
//     the consumers), as in flash_attention_wide.cu. Operands arrive as
//     64-row x 32-column fp32 boxes (8 KB, 128-byte rows, the 128 B
//     swizzle) from 3-D tensor maps (D, S, BH): rows past S read as zeros.
//   - Forward (FwdX, fwd_3xtf32): a work tile is 128 Q rows of one head,
//     resident (two buffers, one at D = 256), and K and V stream past it
//     box by box through a ring of up to 16 one-box stages, so the next
//     key tile's (and the next work tile's, the next head's in the
//     single-tile forward) bytes arrive while this one computes. Each
//     consumer warp owns 16 rows across all D columns and needs no other
//     warp: per key tile S (16 x 64 or 16 x 128) in registers, the softmax
//     on them (online over key tiles of 64 with the correction applied to
//     O in registers; one tile of 128 and the direct softmax in the
//     single-tile forward), then O += P V with P split from the
//     accumulator fragment. O stays in registers (128 a thread at
//     D = 256, beside the scores: the products sum in two groups of
//     n-tiles, as dK/dV does beside dV). O / l and lse = max(s) scale +
//     log(l) leave from registers, 8 bytes a thread.
//   - Backward (BwdX): a work tile's own pair (dQ: Q and dO; dK/dV: K and V)
//     stays resident, in one of two buffers where they fit (D <= 128: the
//     next work tile's pair lands while this one computes; one 128 KB
//     buffer at D = 256), and the other side streams through a ring whose
//     depth is what shared memory leaves. Two designs, by head dim (at
//     D = 64 on the H100 the solo dQ and dK/dV were 1.21x faster than a
//     pair design, at D = 32 dK/dV 1.64x; PERF.md):
//     solo (D <= 64): each consumer warp owns 16 rows (dQ: Q rows; dK/dV:
//     keys) of a 128-row work tile and forms S and dP (S^T, dP^T), P and
//     dS in its own registers, with no exchange; a ring stage holds a
//     whole 64-row tile of both streamed operands (K and V; Q and dO), read
//     by the score and the output products alike. dQ holds D / 2 registers
//     of dQ; dK/dV D / 2 of dV and D / 2 of dK, and takes dV's product
//     before dP^T is formed, so that no more than one score tile is live
//     beside them through a product (else they spilled).
//     pair (D = 128, 256): warp w of
//     warpgroup 0 and warp w of warpgroup 1 own 16 rows of a 64-row work
//     tile. dQ, per 64-key tile: the warpgroup 0 warp computes S and P, the
//     warpgroup 1 warp dP and, from P (handed over in fp32 through the
//     pair's 4 KB buffer, named barriers), dS = P (dP - delta + g_lse),
//     written back to the buffer in fragment order; then the first adds
//     dS K to dQ's columns [0, D / 2), the second to the rest, K streaming
//     again as 64-column items. dK/dV, per 64-row Q tile: the warpgroup 0
//     warp computes S^T and P^T and holds dV (all D columns), the warpgroup
//     1 warp dP^T, dS^T (P^T handed over as in dQ; each then reads its
//     product's A fragments from the pair's buffers) and dK: dV and dK
//     each fit one warp's registers at D = 256, where both would not.
//   - Fused single-tile backward (DqkvX): dkv_solo with the work tile a
//     whole head (its 128 keys; K and V resident, two buffers at D <= 64),
//     which also writes dQ. A Q tile's dQ sums over the keys of all eight
//     warps: each stores its dS^T in a 32 KB shared tile (swizzled so that
//     its 4-byte stores and dQ's 8-byte fragment loads are free of bank
//     conflicts), a named barrier joins the consumers, and each warp forms
//     a 16-row slab of dQ = dS K from the tile and the resident K, its sum
//     over each 64-key half from zero, written once from registers: no
//     atomics, and the result repeats bit for bit. dQ's slab is live only
//     after dS^T is stored. The score products sum each k-step from zero
//     (scores_box's KSTEP), which holds the errors against float64 at
//     S = 128 to the float32 plain version's. At D = 128 only dV stays in
//     registers: dK of each Q tile goes through dk (the last Q tile's sum
//     read back and added), since dV and dK together spilled beside the
//     scores.
//   - Wide-head route (WideX, D > 256): the pair designs with nothing
//     resident (64 rows of one operand are 128 KB at D = 512): per key (Q)
//     tile D / 32 score items of four boxes (column box c of each operand),
//     and output items of 64 columns for each warpgroup, through one ring
//     of six 32 KB stages. dQ: per key tile its score items, P and dS
//     through the pair's two buffers, then its output items: passes of 512
//     columns, 256 a warpgroup in 128 registers, so the three products run
//     once each at D <= 512. dK/dV: dV and dK of 256 columns (128 registers
//     a warp) are a pass; rather than form S^T and dP^T again in each pass
//     (1.5x the products at D = 512), a work tile first forms them for a
//     chunk of up to 32 Q tiles and keeps each warp's operand (P^T or dS^T,
//     4 KB) in a global scratch, which the passes read back: every product
//     once; a later chunk adds the sums the last stored. The forward: the
//     pair design of dQ with S's column boxes split between the pair (each
//     warp sums half of D, the partial sums cross through the pair's
//     buffers and both warps add them in the same order), then the same
//     online softmax in both and P V for each warpgroup's 256 columns:
//     every product once at D <= 512, where the bf16 forward forms all of
//     S in both warpgroups.
//   - A fragment taken from an accumulator (P, dS, P^T, dS^T) keeps its
//     columns 2 t and 2 t + 1 and stands them for k = t and t + 4; the
//     other operand's rows are read in the same order, so no shuffle.
// Outputs leave from registers, 8 bytes a thread. Semantics as the other
// routes: causal masking on global positions q_offset + i >= k_offset + j,
// a row that sees no key gets O = 0, lse = LSE_MASKED and dQ = 0, rows and
// keys past the end are masked (and not written), and the lse cotangent
// g_lse enters dS.

#include "flash_hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int X_BOX_BYTES = SEQ_TILE * X_BOX * 4;  // 8 KB
constexpr int X_PAIRS = CONSUMER_WARPS / 2;        // warp pairs of the pair design
constexpr int X_PAIR_ROWS = SEQ_TILE / X_PAIRS;    // 16: the rows a consumer warp owns
constexpr int X_XCH_BYTES = X_PAIR_ROWS * SEQ_TILE * 4;  // a 16 x 64 fp32 exchange buffer

// Shared memory of the backward at head dim D, in the solo design (D <= 64)
// or the pair design (D = 128, 256), byte offsets from a 1024-aligned base.
// A work tile of ROWS rows
// (dQ: Q rows; dK/dV: keys) keeps its resident pair (operand o's 64-row
// half h, column box c at o RES / 2 + (h CB + c) boxes) in one of RBUFS
// buffers (two where they leave room for three ring stages), and the other
// side streams through the ring: STAGES stages (as many as fit, at most 16)
// of STAGE bytes, the pair design's items of two boxes or the solo design's
// 64-row tiles of both streamed operands. Then the pair design's two
// exchange buffers per warp pair, the ring's full/empty barriers, and the
// resident buffers' full and empty barriers. At D = 256 (pair): one
// 128 KB buffer and 4 stages of 16 KB.
template <int D>
struct BwdX {
  static constexpr bool SOLO = D <= 64;
  static constexpr int CB = D / X_BOX;                        // column boxes
  static constexpr int ROWS = SOLO ? 2 * SEQ_TILE : SEQ_TILE;  // rows of a work tile
  static constexpr int HALF = CB * X_BOX_BYTES;               // 64 rows of one operand
  static constexpr int RES = 2 * (ROWS / SEQ_TILE) * HALF;    // the resident pair
  static constexpr int STAGE = SOLO ? 2 * HALF : 2 * X_BOX_BYTES;
  static constexpr int XCH_ALL = SOLO ? 0 : 2 * X_PAIRS * X_XCH_BYTES;
  static constexpr int AVAIL = (int)SMEM_LIMIT - 2048;
  static constexpr int RBUFS = 2 * RES + XCH_ALL + 3 * STAGE <= AVAIL ? 2 : 1;
  static constexpr int FIT = (AVAIL - RBUFS * RES - XCH_ALL) / STAGE;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr int RING = RBUFS * RES;
  static constexpr int XCH = RING + STAGES * STAGE;
  static constexpr int BAR = XCH + XCH_ALL;
  static constexpr int BYTES = BAR + (2 * STAGES + 2 * RBUFS) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= (int)SMEM_LIMIT, "3xTF32 backward tiles exceed shared memory");
};

// Named barriers of a pair's exchange (64 threads): XCH_FULL + pair once the
// warpgroup 0 warp has written P (P^T), XCH_BACK + pair once the warpgroup 1
// warp has written dS (dQ) or read P^T (dK/dV).
constexpr int XCH_FULL = 1;
constexpr int XCH_BACK = XCH_FULL + X_PAIRS;

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
// each group), and KS_UNROLL of the four k-steps are unrolled: each caller
// picks them for its registers (the pair's dK/dV at D = 256 takes NG = 2
// and 2, since its scores and 128 accumulator registers leave no room for
// more loads in flight; ptxas spilled otherwise). KSTEP: each k-step's sum
// starts from zero instead (8 columns, through three truncations of that
// sum alone) and is added to s in fp32, so that no product of the box
// truncates the box's running sum: fewer registers (no partial sum), an
// fp32 add per value and k-step, and less error (PERF.md).
template <int NG, int KS_UNROLL, bool KSTEP = false>
__device__ __forceinline__ void scores_box(float (&s)[SEQ_TILE / 2], uint32_t a, int a_row0,
                                           uint32_t b, int lane) {
  constexpr int NP = SEQ_TILE / 16 / NG;  // n-tile pairs of a group
  const int r8 = lane & 7, m = lane >> 3;  // the row and matrix this lane addresses
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    float part[KSTEP ? 1 : 8 * NP];
#pragma unroll
    for (int i = 0; i < (KSTEP ? 1 : 8 * NP); ++i) part[i] = 0.f;
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
        if constexpr (KSTEP) {
          float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(c, ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(c + 4, ah, al, bh[2], bh[3], bl[2], bl[3]);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[8 * (NP * grp + np) + i] += c[i];
        } else {
          mma_3xtf32(part + 8 * np, ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(part + 8 * np + 4, ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
    if constexpr (!KSTEP) {
#pragma unroll
      for (int i = 0; i < 8 * NP; ++i) s[8 * NP * grp + i] += part[i];
    }
  }
}

// d (NT n-tiles, 8, 4 or 2) += A B over one output item: B is the item's
// boxes (64 rows, the contraction, by 32 columns each: n-tiles 0-3 in box0
// from column col0, 4-7 in box1), A (16 x 64) an accumulator-layout tile
// (P, dS, P^T or dS^T) whose fragment for k-step j, a0..a3, afrag(j)
// returns (from registers, or from a buffer in fragment order). A fragment takes the
// tile's columns 2 t and 2 t + 1 for k = t and t + 4, so b0 and b1 are B's
// rows 8 j + 2 t and 8 j + 2 t + 1: with columns 8 nt + g they fall on 32
// distinct banks. The item's sum starts from zero and is added to d in
// fp32, in NG groups of n-tiles as in scores_box; AFrag::UNROLL of the
// eight k-steps are unrolled.
template <int NG, int NT = 8, typename AFrag>
__device__ __forceinline__ void product_item(float* d, uint32_t box0, uint32_t box1, AFrag afrag,
                                             int lane, int col0 = 0) {
  constexpr int GT = NT / NG;  // n-tiles of a group
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    float part[4 * GT];
#pragma unroll
    for (int i = 0; i < 4 * GT; ++i) part[i] = 0.f;
#pragma unroll AFrag::UNROLL
    for (int j = 0; j < SEQ_TILE / 8; ++j) {
      const float4 f = afrag(j);
      const uint32_t x[4] = {__float_as_uint(f.x), __float_as_uint(f.y), __float_as_uint(f.z),
                             __float_as_uint(f.w)};
      uint32_t ah[4], al[4];
      split(x, ah, al);
#pragma unroll
      for (int nt = 0; nt < GT; ++nt) {
        const int n = GT * grp + nt;
        const uint32_t box = n < 4 ? box0 : box1;
        const int col = col0 + 8 * (n & 3) + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(lds_u32(box + box_at(8 * j + 2 * t, col)), bh0, bl0);
        split(lds_u32(box + box_at(8 * j + 2 * t + 1, col)), bh1, bl1);
        mma_3xtf32(part + 4 * nt, ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * GT; ++i) d[4 * GT * grp + i] += part[i];
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

// Rows row, row + 8 of a 16 x W accumulator, each value x of row half h
// as out_value(x, h), to columns [col0, col0 + min(W, ncols)) of out (ld
// floats a row; rows past nrows not written; ncols a multiple of 8), 8
// bytes a thread.
template <int W, typename Out>
__device__ __forceinline__ void store_acc(float* out, int ld, const float (&acc)[W / 2],
                                          Out out_value, int row, int nrows, int col0, int lane,
                                          int ncols = W) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= nrows) continue;
    float* o = out + (size_t)(row + 8 * h) * ld + col0 + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
      if (8 * nt < ncols)
        *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(
            out_value(acc[4 * nt + 2 * h], h), out_value(acc[4 * nt + 2 * h + 1], h));
  }
}

// Adds to a 16 x W accumulator the values that store_acc with the same
// arguments wrote (and nothing where it writes nothing).
template <int W>
__device__ __forceinline__ void add_stored(float (&acc)[W / 2], const float* in, int ld, int row,
                                           int nrows, int col0, int lane, int ncols = W) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= nrows) continue;
    const float* o = in + (size_t)(row + 8 * h) * ld + col0 + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
      if (8 * nt < ncols) {
        const float2 x = *reinterpret_cast<const float2*>(o + 8 * nt);
        acc[4 * nt + 2 * h] += x.x;
        acc[4 * nt + 2 * h + 1] += x.y;
      }
  }
}

// Shared memory of a backward block of layout L (BwdX): the ring and the
// resident buffers' barriers, set up before the block syncs. Work tile n
// (the block's n-th) keeps its pair in buffer n % RBUFS.
template <typename L>
struct XSmem {
  uint32_t base;
  unsigned char* smem;  // base, generic
  Ring<L::STAGE> ring;
  __device__ __forceinline__ uint32_t res(int n) const { return base + (n % L::RBUFS) * L::RES; }
  __device__ __forceinline__ uint32_t res_full(int n) const {
    return base + L::BAR + 16 * L::STAGES + 8 * (n % L::RBUFS);
  }
  __device__ __forceinline__ uint32_t res_empty(int n) const { return res_full(n) + 8 * L::RBUFS; }
  __device__ __forceinline__ int res_phase(int n) const { return (n / L::RBUFS) & 1; }
};

template <typename L>
__device__ __forceinline__ XSmem<L> x_smem(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const XSmem<L> x{base, smem_raw + (base - raw),
                   make_ring<L::STAGE>(base + L::RING, L::BAR - L::RING, L::STAGES)};
  if (threadIdx.x == 0) {
    for (int b = 0; b < L::RBUFS; ++b) {
      mbar_init(x.res_full(b), 1);
      mbar_init(x.res_empty(b), CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return x;
}

// The producer's load of work tile n's resident pair, rows [row0, row0 +
// L::ROWS) of a and of b of head bh, once the consumers have released its
// buffer.
template <typename L>
__device__ __forceinline__ void load_resident(const XSmem<L>& x, int n, const CUtensorMap* a,
                                              const CUtensorMap* b, int row0, int bh) {
  mbar_wait(x.res_empty(n), x.res_phase(n) ^ 1);
  const uint32_t full = x.res_full(n), dst = x.res(n);
  mbar_arrive_expect_tx(full, L::RES);
  for (int h = 0; h < L::ROWS / SEQ_TILE; ++h)
    for (int c = 0; c < L::CB; ++c) {
      const uint32_t at = dst + (h * L::CB + c) * X_BOX_BYTES;
      tma_load_3d(at, a, full, X_BOX * c, row0 + SEQ_TILE * h, bh);
      tma_load_3d(at + L::RES / 2, b, full, X_BOX * c, row0 + SEQ_TILE * h, bh);
    }
}

// The producer's ring item `it` of the pair design, two boxes: columns
// col_a of a, then col_b of b, rows row0 of head bh.
template <typename L>
__device__ __forceinline__ void load_item(const XSmem<L>& x, int it, const CUtensorMap* a,
                                          int col_a, const CUtensorMap* b, int col_b, int row0,
                                          int bh) {
  const uint32_t tile = x.ring.fill(it, L::STAGE);
  tma_load_3d(tile, a, x.ring.bar(it), col_a, row0, bh);
  tma_load_3d(tile + X_BOX_BYTES, b, x.ring.bar(it), col_b, row0, bh);
}

// The producer's ring item `it` of the solo design: rows [row0, row0 + 64)
// of head bh across D, a's L::CB boxes, then b's.
template <typename L>
__device__ __forceinline__ void load_tiles(const XSmem<L>& x, int it, const CUtensorMap* a,
                                           const CUtensorMap* b, int row0, int bh) {
  const uint32_t tile = x.ring.fill(it, L::STAGE);
  for (int c = 0; c < L::CB; ++c) {
    tma_load_3d(tile + c * X_BOX_BYTES, a, x.ring.bar(it), X_BOX * c, row0, bh);
    tma_load_3d(tile + (L::CB + c) * X_BOX_BYTES, b, x.ring.bar(it), X_BOX * c, row0, bh);
  }
}

// A consumer warp is done with a resident buffer whose empty barrier is bar.
__device__ __forceinline__ void release_resident(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The backward kernels' arguments: the four operands' tensor maps (q, k, v,
// dO), the outputs ([BH, S, D] fp32: dq, or dk and dv), the row vectors lse,
// delta and g_lse ([BH, Sq] fp32), and the shape and masking.
#define X_BWD_PARAMS                                                                        \
  const CUtensorMap *tm_q, const CUtensorMap *tm_k, const CUtensorMap *tm_v,                \
      const CUtensorMap *tm_do, const float *__restrict__ lse,                              \
      const float *__restrict__ delta, const float *__restrict__ glse, int BH, int Sq, int Sk, \
      float scale, int causal, int q_offset, int k_offset

// dQ in the pair design (D = 128, 256), persistent: a grid of one block per
// SM walks the work tiles (bh, 64 Q rows) and loops over the key tiles
// their rows can see. dq = scale * sum_j dS_j K_j, [BH, Sq, D] fp32. Output
// item u of a key tile (64 columns of K, two boxes) is added by warpgroup
// u % 2, which holds columns [D / 2 wg, D / 2 (wg + 1)); the items
// alternate so that both work at once.
template <int D>
__device__ __forceinline__ void dq_pair(float* __restrict__ dq, X_BWD_PARAMS) {
  using L = BwdX<D>;
  static_assert(!L::SOLO);
  constexpr int CB = L::CB;
  constexpr int NI = CB / 2;  // output items of a key tile
  extern __shared__ unsigned char smem_raw[];
  const XSmem<L> x = x_smem<L>(smem_raw);
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int nwork = BH * qtiles;  // work tile w: Q tile w % qtiles of head w / qtiles
  const int wg = threadIdx.x / WG;
  auto item_col = [](int u) { return D / 2 * (u & 1) + 2 * X_BOX * (u >> 1); };

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile Q and dO; per key tile its score
    // items (K and V boxes of 32 columns), then its output items (K).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int q0 = w % qtiles * SEQ_TILE, bh = w / qtiles;
        load_resident(x, n, tm_q, tm_do, q0, bh);
        const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * SEQ_TILE;
          for (int c = 0; c < CB; ++c, ++it)
            load_item(x, it, tm_k, X_BOX * c, tm_v, X_BOX * c, k0, bh);
          for (int u = 0; u < NI; ++u, ++it)
            load_item(x, it, tm_k, item_col(u), tm_k, item_col(u) + X_BOX, k0, bh);
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
    float* const xch = reinterpret_cast<float*>(x.smem + L::XCH + 2 * pair * X_XCH_BYTES);
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int q0 = w % qtiles * SEQ_TILE, bh = w / qtiles;
      const int row0 = q0 + r;  // and row0 + 8
      const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
      const uint32_t res = x.res(n) + wg * L::HALF;  // Q or dO
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
      float acc[D / 4];  // dQ: the pair's 16 rows by this warpgroup's D / 2 columns
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
      mbar_wait(x.res_full(n), x.res_phase(n));
      if (nk == 0) release_resident(x.res_empty(n), lane);

      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * SEQ_TILE;
        // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), 16 x 64.
        float s[SEQ_TILE / 2];
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
        for (int c = 0; c < CB; ++c, ++it) {
          x.ring.wait(it);
          scores_box<1, 4>(s, res + c * X_BOX_BYTES, X_PAIR_ROWS * pair,
                           x.ring.tile(it) + wg * X_BOX_BYTES, lane);
          x.ring.release(it, lane);
        }
        if (kt == nk - 1) release_resident(x.res_empty(n), lane);

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
        for (int u = 0; u < NI; ++u, ++it) {
          x.ring.wait(it);
          if ((u & 1) == wg) {
            float* const d = acc + 32 * (u >> 1);
            const uint32_t t = x.ring.tile(it);
            if (wg == 0)
              product_item<1>(d, t, t + X_BOX_BYTES,
                              SmemFrag<8>{reinterpret_cast<const float4*>(xch), lane}, lane);
            else
              product_item<1>(d, t, t + X_BOX_BYTES, RegFrag{s}, lane);
          }
          x.ring.release(it, lane);
        }
      }
      store_acc<D / 2>(dq + (size_t)bh * Sq * D, D, acc,
                       [scale](float x, int) { return scale * x; }, row0, Sq, D / 2 * wg, lane);
    }
  }
}

// dQ in the solo design (D <= 64), persistent: work tiles of 128 Q rows
// (bh, q0), each consumer warp 16 of them. Per key tile, one ring item (K
// and V, 64 rows each across D): the warp computes S = Q K^T and dP =
// dO V^T (16 x 64 each), P and dS = P (dP + g_lse - delta) in registers,
// and dQ += dS K with dS's fragments taken from them; dQ (D / 2 registers)
// leaves as scale dQ.
template <int D>
__device__ __forceinline__ void dq_solo(float* __restrict__ dq, X_BWD_PARAMS) {
  using L = BwdX<D>;
  static_assert(L::SOLO);
  constexpr int CB = L::CB;
  constexpr int OB = CB >= 2 ? 2 : 1;  // K boxes of an output item: 64 columns (32 at D = 32)
  // Groups of n-tiles and unrolled k-steps of the score products (S, dP)
  // and the output product (scores_box, product_item): dP's with two
  // k-steps unrolled (the fastest choice without spills on the H100;
  // variants built side by side, PERF.md).
  constexpr int S_NG = 1, S_KS = 4, DP_NG = 1, DP_KS = 2, P_NG = 1;
  extern __shared__ unsigned char smem_raw[];
  const XSmem<L> x = x_smem<L>(smem_raw);
  const int qtiles = (Sq + L::ROWS - 1) / L::ROWS;
  const int nwork = BH * qtiles;  // work tile w: Q tile w % qtiles of head w / qtiles
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile Q and dO, per key tile K and V.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int q0 = w % qtiles * L::ROWS, bh = w / qtiles;
        load_resident(x, n, tm_q, tm_do, q0, bh);
        const int nk = key_tiles<L::ROWS>(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int kt = 0; kt < nk; ++kt, ++it) load_tiles(x, it, tm_k, tm_v, kt * SEQ_TILE, bh);
      }
    }
  } else {
    // Consumer warp: rows [16 (warp % 4), + 16) of warpgroup wg's 64.
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int wrow = X_PAIR_ROWS * (threadIdx.x / 32 % 4);
    const float sl2 = scale * LOG2E;
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int q0 = w % qtiles * L::ROWS, bh = w / qtiles;
      const int row_first = q0 + SEQ_TILE * wg + wrow;  // this warp's first row
      const int row0 = row_first + (lane >> 2);         // this thread's rows row0, row0 + 8
      const int nk = key_tiles<L::ROWS>(q0, Sq, Sk, causal, q_offset, k_offset);
      const uint32_t sq = x.res(n) + wg * L::HALF;  // Q's box c at + c boxes
      const uint32_t sdo = sq + L::RES / 2;
      // lse log2(e) and g_lse - delta of this thread's two rows; rows past
      // Sq get lse = LSE_MASKED: their P is 0.
      float lse2[2], gd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = row0 + 8 * h;
        const size_t at = (size_t)bh * Sq + qi;
        lse2[h] = qi < Sq ? lse[at] * LOG2E : LSE_MASKED;
        gd[h] = qi < Sq ? glse[at] - delta[at] : 0.f;
      }
      float acc[D / 2];  // dQ: the warp's 16 rows by D columns
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(x.res_full(n), x.res_phase(n));
      if (nk == 0) release_resident(x.res_empty(n), lane);

      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int k0 = kt * SEQ_TILE;
        // A warp whose rows are past Sq, or causally see no key of the
        // tile, only waits for and releases it.
        const bool sees =
            row_first < Sq && !(causal && q_offset + row_first + X_PAIR_ROWS - 1 < k_offset + k0);
        const uint32_t t = x.ring.tile(it);  // K's box c at + c boxes, V's at + CB + c
        float s[SEQ_TILE / 2], dp[SEQ_TILE / 2];
        x.ring.wait(it);
        if (sees) {
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 1
          for (int c = 0; c < CB; ++c) {
            scores_box<S_NG, S_KS>(s, sq + c * X_BOX_BYTES, wrow, t + c * X_BOX_BYTES, lane);
            scores_box<DP_NG, DP_KS>(dp, sdo + c * X_BOX_BYTES, wrow,
                                     t + (CB + c) * X_BOX_BYTES, lane);
          }
        }
        if (kt == nk - 1) release_resident(x.res_empty(n), lane);  // the last read of Q and dO
        if (sees) {
          // dS = P (dP + g_lse - delta) in place of S; keys past Sk read
          // zero rows of K but get P = 0.
          const bool mask = k0 + SEQ_TILE > Sk ||
                            (causal && q_offset + row_first < k_offset + k0 + SEQ_TILE - 1);
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) {
            const int kj = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
            const int h = (i >> 1) & 1;
            float pv = exp2f(fmaf(s[i], sl2, -lse2[h]));
            if (mask && (kj >= Sk || (causal && q_offset + row0 + 8 * h < k_offset + kj)))
              pv = 0.f;
            s[i] = pv * (dp[i] + gd[h]);
          }
          // dQ += dS K, per output item of OB K boxes.
#pragma unroll
          for (int u = 0; u < CB / OB; ++u)
            product_item<P_NG, 4 * OB>(acc + 16 * OB * u, t + OB * u * X_BOX_BYTES,
                                       t + (OB * u + OB - 1) * X_BOX_BYTES, RegFrag{s}, lane);
        }
        x.ring.release(it, lane);
      }
      store_acc<D>(dq + (size_t)bh * Sq * D, D, acc, [scale](float x, int) { return scale * x; },
                   row0, Sq, 0, lane);
    }
  }
}

// dK/dV in the pair design (D = 128, 256), persistent: a grid of one block
// per SM walks the work tiles (bh, 64 keys) and loops over the Q tiles that
// can see the keys. dV = sum_i P_ij^T dO_i (warpgroup 0), dK = scale *
// sum_i dS_ij^T Q_i (warpgroup 1), [BH, Sk, D] fp32. Per Q tile the output
// items (64 columns, two boxes, of dO and of Q by turns) go to warpgroup
// u % 2.
template <int D>
__device__ __forceinline__ void dkv_pair(float* __restrict__ dk, float* __restrict__ dv,
                                         X_BWD_PARAMS) {
  using L = BwdX<D>;
  static_assert(!L::SOLO);
  constexpr int CB = L::CB;
  constexpr int NI = CB;  // output items of a Q tile
  // Beside dV's or dK's 128 registers at D = 256 the score product sums in
  // two groups of n-tiles with two k-steps unrolled (ptxas spilled with
  // more) and the output product reads one k-step at a time; at D = 128
  // the score product's k-steps are all unrolled and the output product
  // reads four ahead. The output product sums in one group of n-tiles. The
  // fastest choices without spills on the H100 (variants built side by
  // side, PERF.md).
  constexpr bool HEAVY = D == 256;
  constexpr int S_NG = HEAVY ? 2 : 1, S_KS = HEAVY ? 2 : 4;
  constexpr int P_UNROLL = HEAVY ? 1 : 4;
  extern __shared__ unsigned char smem_raw[];
  const XSmem<L> x = x_smem<L>(smem_raw);
  const int ktiles = (Sk + SEQ_TILE - 1) / SEQ_TILE;
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int nwork = BH * ktiles;  // work tile w: key tile w % ktiles of head w / ktiles
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile K and V; per Q tile its score
    // items (Q and dO boxes of 32 columns), then its output items (dO and Q
    // by turns).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int k0 = w % ktiles * SEQ_TILE, bh = w / ktiles;
        load_resident(x, n, tm_k, tm_v, k0, bh);
        for (int qt = first_query_tile(k0, causal, q_offset, k_offset); qt < qtiles; ++qt) {
          const int q0 = qt * SEQ_TILE;
          for (int c = 0; c < CB; ++c, ++it)
            load_item(x, it, tm_q, X_BOX * c, tm_do, X_BOX * c, q0, bh);
          for (int u = 0; u < NI; ++u, ++it) {
            const CUtensorMap* m = (u & 1) ? tm_q : tm_do;
            const int col0 = 2 * X_BOX * (u >> 1);
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
    float* const xch = reinterpret_cast<float*>(x.smem + L::XCH + 2 * pair * X_XCH_BYTES);
    int it = 0, n = 0;
    int pt = 0;  // Q tiles so far: P^T hand-offs
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int k0 = w % ktiles * SEQ_TILE, bh = w / ktiles;
      const int key0 = k0 + r;  // and key0 + 8
      const int qt0 = first_query_tile(k0, causal, q_offset, k_offset);
      const uint32_t res = x.res(n) + wg * L::HALF;  // K or V
      float acc[D / 2];  // dV or dK: the pair's 16 keys by D columns
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(x.res_full(n), x.res_phase(n));
      if (qt0 >= qtiles) release_resident(x.res_empty(n), lane);

      for (int qt = qt0; qt < qtiles; ++qt, ++pt) {
        const int q0 = qt * SEQ_TILE;
        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 16 x 64.
        float s[SEQ_TILE / 2];
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
        for (int c = 0; c < CB; ++c, ++it) {
          x.ring.wait(it);
          scores_box<S_NG, S_KS>(s, res + c * X_BOX_BYTES, X_PAIR_ROWS * pair,
                                 x.ring.tile(it) + wg * X_BOX_BYTES, lane);
          x.ring.release(it, lane);
        }
        if (qt == qtiles - 1) release_resident(x.res_empty(n), lane);

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
        for (int u = 0; u < NI; ++u, ++it) {
          x.ring.wait(it);
          if ((u & 1) == wg)
            product_item<1>(acc + 32 * (u >> 1), x.ring.tile(it), x.ring.tile(it) + X_BOX_BYTES,
                            SmemFrag<P_UNROLL>{wg == 0 ? pt4 : dst4, lane}, lane);
          x.ring.release(it, lane);
        }
      }
      const float mul = wg == 0 ? 1.f : scale;
      store_acc<D>((wg == 0 ? dv : dk) + (size_t)bh * Sk * D, D, acc,
                   [mul](float x, int) { return mul * x; }, key0, Sk, 0, lane);
    }
    // Take the partner's arrival after its last read of P^T.
    if (wg == 0 && pt > 0) named_sync(XCH_BACK + pair, 64);
  }
}

// dK/dV in the solo design (D <= 64), persistent: work tiles of 128 keys
// (bh, k0), each consumer warp 16 of them. Per Q tile that can see the
// keys, one ring item (Q and dO, 64 rows each across D): the warp computes
// S^T = K Q^T and dP^T = V dO^T (16 x 64 each), P^T and dS^T = P^T (dP^T +
// g_lse - delta) in registers, and dV += P^T dO, dK += dS^T Q with their A
// fragments taken from them (D / 2 registers each of dV and dK).
template <int D>
__device__ __forceinline__ void dkv_solo(float* __restrict__ dk, float* __restrict__ dv,
                                         X_BWD_PARAMS) {
  using L = BwdX<D>;
  static_assert(L::SOLO);
  constexpr int CB = L::CB;
  constexpr int OB = CB >= 2 ? 2 : 1;  // boxes of an output item: 64 columns (32 at D = 32)
  // Groups of n-tiles and unrolled k-steps of the score products (S^T;
  // dP^T, formed beside P^T) and the output products (scores_box,
  // product_item). At D = 64, beside dV's and dK's 64 registers, the score
  // products unroll two k-steps (S^T) and one (dP^T): ptxas spilled with
  // more (variants built side by side on the H100, PERF.md).
  constexpr int S_NG = 1, S_KS = D == 64 ? 2 : 4, DP_NG = 1, DP_KS = D == 64 ? 1 : 4, P_NG = 1;
  extern __shared__ unsigned char smem_raw[];
  const XSmem<L> x = x_smem<L>(smem_raw);
  const int ktiles = (Sk + L::ROWS - 1) / L::ROWS;
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int nwork = BH * ktiles;  // work tile w: key tile w % ktiles of head w / ktiles
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile K and V, per Q tile Q and dO.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int k0 = w % ktiles * L::ROWS, bh = w / ktiles;
        load_resident(x, n, tm_k, tm_v, k0, bh);
        for (int qt = first_query_tile(k0, causal, q_offset, k_offset); qt < qtiles; ++qt, ++it)
          load_tiles(x, it, tm_q, tm_do, qt * SEQ_TILE, bh);
      }
    }
  } else {
    // Consumer warp: keys [16 (warp % 4), + 16) of warpgroup wg's 64.
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int wrow = X_PAIR_ROWS * (threadIdx.x / 32 % 4);
    const float sl2 = scale * LOG2E;
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int k0 = w % ktiles * L::ROWS, bh = w / ktiles;
      const int key_first = k0 + SEQ_TILE * wg + wrow;  // this warp's first key
      const int key0 = key_first + (lane >> 2);         // this thread's keys key0, key0 + 8
      const int qt0 = first_query_tile(k0, causal, q_offset, k_offset);
      const uint32_t sk = x.res(n) + wg * L::HALF;  // K's box c at + c boxes
      const uint32_t sv = sk + L::RES / 2;
      float dv_acc[D / 2], dk_acc[D / 2];  // the warp's 16 keys by D columns
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
      mbar_wait(x.res_full(n), x.res_phase(n));
      if (qt0 >= qtiles) release_resident(x.res_empty(n), lane);

      for (int qt = qt0; qt < qtiles; ++qt, ++it) {
        const int q0 = qt * SEQ_TILE;
        // A warp whose keys are past Sk, or that no row of the tile sees,
        // only waits for and releases it.
        const bool sees = key_first < Sk && !(causal && q_offset + q0 + SEQ_TILE - 1 <
                                                            k_offset + key_first);
        const uint32_t t = x.ring.tile(it);  // Q's box c at + c boxes, dO's at + CB + c
        // This thread's 16 Q columns: element i of a score tile is column
        // 8 (i / 4) + 2 tq + i % 2, value e = 2 (i / 4) + i % 2 of rv (lse
        // log2(e), then g_lse - delta). Rows past Sq get lse = LSE_MASKED:
        // their P is exactly 0.
        auto q_row = [&](int e) { return q0 + 8 * (e >> 1) + 2 * tq + (e & 1); };
        float s[SEQ_TILE / 2], dp[SEQ_TILE / 2], rv[16];
        x.ring.wait(it);
        if (sees) {
          // S^T = K Q^T, then P^T in its place: the causal mask on global
          // positions; keys past Sk are never written, so they need none.
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
#pragma unroll 1
          for (int c = 0; c < CB; ++c)
            scores_box<S_NG, S_KS>(s, sk + c * X_BOX_BYTES, wrow, t + c * X_BOX_BYTES, lane);
#pragma unroll
          for (int e = 0; e < 16; ++e)
            rv[e] = q_row(e) < Sq ? lse[(size_t)bh * Sq + q_row(e)] * LOG2E : LSE_MASKED;
          const bool mask = causal && q_offset + q0 < k_offset + key_first + X_PAIR_ROWS - 1;
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) {
            const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
            float pv = exp2f(fmaf(s[i], sl2, -rv[2 * (i >> 2) + (i & 1)]));
            if (mask && q_offset + q0 + c < k_offset + key0 + 8 * ((i >> 1) & 1)) pv = 0.f;
            s[i] = pv;
          }
          // dV += P^T dO before dP^T is formed: beside dV and dK, no more
          // than one score tile is live during a product.
#pragma unroll
          for (int u = 0; u < CB / OB; ++u) {
            const uint32_t b = t + (CB + OB * u) * X_BOX_BYTES;  // dO's boxes
            product_item<P_NG, 4 * OB>(dv_acc + 16 * OB * u, b, b + (OB - 1) * X_BOX_BYTES,
                                       RegFrag{s}, lane);
          }
          // dP^T = V dO^T.
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) dp[i] = 0.f;
#pragma unroll 1
          for (int c = 0; c < CB; ++c)
            scores_box<DP_NG, DP_KS>(dp, sv + c * X_BOX_BYTES, wrow, t + (CB + c) * X_BOX_BYTES,
                                     lane);
        }
        if (qt == qtiles - 1) release_resident(x.res_empty(n), lane);  // the last read of K, V
        if (sees) {
          // dS^T = P^T (dP^T + g_lse - delta) in place of dP^T, then
          // dK += dS^T Q.
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const size_t at = (size_t)bh * Sq + q_row(e);
            rv[e] = q_row(e) < Sq ? glse[at] - delta[at] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i)
            dp[i] = s[i] * (dp[i] + rv[2 * (i >> 2) + (i & 1)]);
#pragma unroll
          for (int u = 0; u < CB / OB; ++u) {
            const uint32_t b = t + OB * u * X_BOX_BYTES;  // Q's boxes
            product_item<P_NG, 4 * OB>(dk_acc + 16 * OB * u, b, b + (OB - 1) * X_BOX_BYTES,
                                       RegFrag{dp}, lane);
          }
        }
        x.ring.release(it, lane);
      }
      store_acc<D>(dv + (size_t)bh * Sk * D, D, dv_acc, [](float x, int) { return x; }, key0, Sk,
                   0, lane);
      store_acc<D>(dk + (size_t)bh * Sk * D, D, dk_acc, [scale](float x, int) { return scale * x; },
                   key0, Sk, 0, lane);
    }
  }
}

#define X_BWD_ARGS                                                                          \
  &tm_q, &tm_k, &tm_v, &tm_do, lse, delta, glse, BH, Sq, Sk, scale, causal, q_offset, k_offset

// dQ at head dim D: the solo design at D <= 64, else the pair.
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dq_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dq,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ glse, int BH, int Sq, int Sk, float scale,
                       int causal, int q_offset, int k_offset) {
  if constexpr (BwdX<D>::SOLO)
    dq_solo<D>(dq, X_BWD_ARGS);
  else
    dq_pair<D>(dq, X_BWD_ARGS);
}

// dK/dV at head dim D: the solo design at D <= 64, else the pair.
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dkv_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dk,
                        float* __restrict__ dv, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ glse, int BH,
                        int Sq, int Sk, float scale, int causal, int q_offset, int k_offset) {
  if constexpr (BwdX<D>::SOLO)
    dkv_solo<D>(dk, dv, X_BWD_ARGS);
  else
    dkv_pair<D>(dk, dv, X_BWD_ARGS);
}

#undef X_BWD_PARAMS
#undef X_BWD_ARGS

// ---------------------------------------------------------------------------
// The fused single-tile backward (flash_dqkv_3xtf32_kernel): dQ, dK and dV
// of heads whose Sq and Sk are at most 128, the float32 calls of
// flash_attention_single.cu's launch_dqkv, at D = 32, 64 and 128.
// ---------------------------------------------------------------------------

// Shared memory of the fused backward at head dim D, byte offsets from a
// 1024-aligned base: a head's K and V (its 128 keys, the work tile: key
// half h, column box c of operand o at o RES / 2 + (h CB + c) boxes) in one
// of RBUFS buffers (two where they leave room for two ring stages, so that
// the next head's K and V land while this one computes), the ring of
// STAGES stages of a 64-row Q tile and its dO across D (as many as fit, at
// most 16), the dS tile of a Q tile (64 rows by the 128 keys, fp32), then
// the ring's and the buffers' barriers. D = 64: two buffers, two stages;
// D = 128: one buffer, one stage.
constexpr int DQKV_KEYS = 2 * SEQ_TILE;  // keys of a head: the work tile
template <int D>
struct DqkvX {
  static constexpr int CB = D / X_BOX;
  static constexpr int ROWS = DQKV_KEYS;
  static constexpr int HALF = CB * X_BOX_BYTES;         // 64 rows of one operand
  static constexpr int RES = 2 * 2 * HALF;              // K and V of a head
  static constexpr int STAGE = 2 * HALF;                // a Q tile and its dO
  static constexpr int DS_BYTES = SEQ_TILE * ROWS * 4;  // 32 KB
  static constexpr int AVAIL = (int)SMEM_LIMIT - 2048;
  static constexpr int RBUFS = 2 * RES + DS_BYTES + 2 * STAGE <= AVAIL ? 2 : 1;
  static constexpr int FIT = (AVAIL - RBUFS * RES - DS_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr int RING = RBUFS * RES;
  static constexpr int DS = RING + STAGES * STAGE;
  static constexpr int BAR = DS + DS_BYTES;
  static constexpr int BYTES = BAR + (2 * STAGES + 2 * RBUFS) * 8 + 1024;  // + alignment slack
  static_assert(STAGES >= 1 && BYTES <= (int)SMEM_LIMIT,
                "3xTF32 fused backward tiles exceed shared memory");
};

// The dS tile: Q row q of a Q tile at q DQKV_KEYS floats, its key k at
// k ^ ds_swizzle(q). The XOR moves k within its aligned group of 32 keys
// and keeps the pairs 2 t, 2 t + 1 together, so that both the warps that
// store dS^T (4-byte stores: lane (g, t) at key g, row 2 t + e) and those
// that read dS for dQ (8-byte loads of keys 2 t, 2 t + 1 at row g) hit 32
// distinct banks in each half-warp.
__device__ __forceinline__ int ds_swizzle(int q) { return 8 * ((q & 3) ^ ((q >> 2) & 1)); }

// The A fragments of dQ = dS K over key half kh from the dS tile: k-step j
// takes keys 64 kh + 8 j + 2 t and + 1 (as k = t and t + 4, the order in
// which product_item reads K's rows) at Q rows row and row + 8.
struct DsFrag {
  static constexpr int UNROLL = SEQ_TILE / 8;
  uint32_t row;  // the shared address of Q row `row` of the tile
  int key0;      // 64 kh + 2 t
  int sw;        // ds_swizzle of the two rows (they differ by 8)
  __device__ __forceinline__ float4 operator()(int j) const {
    const uint32_t at = row + 4 * ((key0 + 8 * j) ^ sw);
    float2 lo, hi;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(lo.x), "=f"(lo.y) : "r"(at));
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(hi.x), "=f"(hi.y)
                 : "r"(at + 8 * DQKV_KEYS * 4));
    return make_float4(lo.x, hi.x, lo.y, hi.y);
  }
};

// Named barriers of the fused backward's 256 consumer threads: every warp
// has stored its dS^T of the Q tile (DS_FULL), or has read the last Q
// tile's dS (DS_FREE).
constexpr int DS_FULL = 1;
constexpr int DS_FREE = 2;

// The fused backward, persistent: a grid of min(BH, SMs) blocks walks the
// heads, each head one work tile (its 128 keys; K and V resident). Each
// consumer warp owns 16 keys, as dkv_solo's, and for every 64-row Q tile
// (Q and dO in one ring item) forms S^T, P^T, dV += P^T dO, dP^T, dS^T and
// dK += dS^T Q in its own registers; it stores dS^T into the dS tile, and
// once every warp has (DS_FULL), forms a 16-row slab of the Q tile's dQ =
// dS K (rows 16 (warp % 4), half wg of the columns) over all 128 keys, from
// the dS tile and the resident K, and writes it from registers: the whole
// key range is in the block, so dQ is written once, with no atomics. At
// D = 128, where dV and dK would take 128 registers, only dV stays in
// registers: dK of each Q tile is added to what the last Q tile stored in
// dk, one output item at a time (holding both spilled 524 bytes:
// PERF.md). dv = sum_i P_ij^T dO_i, dk = scale sum_i dS_ij^T Q_i,
// dq = scale sum_j dS_ij K_j, rows past Sq and keys past Sk masked and not
// written.
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dqkv_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ glse, int BH, int Sq, int Sk, float scale,
                         int causal, int q_offset, int k_offset) {
  using L = DqkvX<D>;
  constexpr int CB = L::CB;
  constexpr int IB = D < 64 ? 1 : 2;    // boxes of an output item
  constexpr int NI = D / (IB * X_BOX);  // output items
  constexpr int W = D / 2;              // columns of a warp's dQ slab
  // dK of each Q tile added to what the last Q tile stored in dk, one
  // output item at a time, instead of held in registers across Q tiles.
  constexpr bool DK_STORED = D > 64;
  // The score products sum each k-step from zero (scores_box's KSTEP:
  // summed per box, dK's error against float64 at S = 128 passed
  // F64_ERR_RATIO times the float32 plain version's; PERF.md),
  // unrolling two k-steps of S^T and one of dP^T, as
  // dkv_solo at D = 64 (beside dV and dK ptxas spilled with more).
  extern __shared__ unsigned char smem_raw[];
  const XSmem<L> x = x_smem<L>(smem_raw);
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per head K and V, per Q tile Q and dO.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++n) {
        load_resident(x, n, &tm_k, &tm_v, 0, bh);
        for (int qt = 0; qt < qtiles; ++qt, ++it)
          load_tiles(x, it, &tm_q, &tm_do, qt * SEQ_TILE, bh);
      }
    }
  } else {
    // Consumer warp: keys [16 (warp % 4), + 16) of half wg of the head's
    // 128, and dQ rows [16 (warp % 4), + 16) of each Q tile.
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int wrow = X_PAIR_ROWS * (threadIdx.x / 32 % 4);
    const int key_first = SEQ_TILE * wg + wrow;  // this warp's first key
    const int key0 = key_first + (lane >> 2);     // this thread's keys key0, key0 + 8
    const float sl2 = scale * LOG2E;
    const int khalves = (Sk + SEQ_TILE - 1) / SEQ_TILE;  // key halves that hold a key
    float* const ds_tile = reinterpret_cast<float*>(x.smem + L::DS);
    const int frag_row = wrow + (lane >> 2);  // this thread's dS rows (and + 8) in the slab
    const DsFrag ds_frag0{x.base + L::DS + 4 * frag_row * DQKV_KEYS, 2 * tq,
                          ds_swizzle(frag_row)};
    int it = 0, n = 0;
    for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++n) {
      const uint32_t sk = x.res(n) + wg * L::HALF;  // this warp's K rows: box c at + c boxes
      const uint32_t sv = sk + L::RES / 2;
      float dv_acc[D / 2], dk_acc[DK_STORED ? 1 : D / 2];  // the warp's 16 keys by D columns
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv_acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (DK_STORED ? 1 : D / 2); ++i) dk_acc[i] = 0.f;
      float* const dk_head = dk + (size_t)bh * Sk * D;
      mbar_wait(x.res_full(n), x.res_phase(n));
      for (int qt = 0; qt < qtiles; ++qt, ++it) {
        const int q0 = qt * SEQ_TILE;
        // A warp whose keys are past Sk, or that no row of the tile sees,
        // stores zeros as its dS^T.
        const bool sees = key_first < Sk && !(causal && q_offset + q0 + SEQ_TILE - 1 <
                                                            k_offset + key_first);
        const uint32_t t = x.ring.tile(it);  // Q's box c at + c boxes, dO's at + CB + c
        // This thread's 16 Q columns: element i of a score tile is column
        // 8 (i / 4) + 2 tq + i % 2, value e = 2 (i / 4) + i % 2 of rv (lse
        // log2(e), then g_lse - delta). Rows past Sq get lse = LSE_MASKED:
        // their P is exactly 0.
        auto q_row = [&](int e) { return q0 + 8 * (e >> 1) + 2 * tq + (e & 1); };
        float s[SEQ_TILE / 2], dp[SEQ_TILE / 2], rv[16];
        x.ring.wait(it);
        if (sees) {
          // S^T = K Q^T, then P^T in its place: keys past Sk (zero rows of
          // K, whose dS the dQ product reads) and causally hidden keys get
          // P = 0.
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
#pragma unroll 1
          for (int c = 0; c < CB; ++c)
            scores_box<1, 2, true>(s, sk + c * X_BOX_BYTES, wrow, t + c * X_BOX_BYTES, lane);
#pragma unroll
          for (int e = 0; e < 16; ++e)
            rv[e] = q_row(e) < Sq ? lse[(size_t)bh * Sq + q_row(e)] * LOG2E : LSE_MASKED;
          const bool mask = key_first + X_PAIR_ROWS > Sk ||
                            (causal && q_offset + q0 < k_offset + key_first + X_PAIR_ROWS - 1);
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) {
            const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
            const int key = key0 + 8 * ((i >> 1) & 1);
            float pv = exp2f(fmaf(s[i], sl2, -rv[2 * (i >> 2) + (i & 1)]));
            if (mask && (key >= Sk || (causal && q_offset + q0 + c < k_offset + key))) pv = 0.f;
            s[i] = pv;
          }
          // dV += P^T dO, before dP^T is formed.
#pragma unroll
          for (int u = 0; u < NI; ++u) {
            const uint32_t bo = t + (CB + IB * u) * X_BOX_BYTES;  // dO's boxes
            product_item<1, 4 * IB>(dv_acc + 16 * IB * u, bo, bo + (IB - 1) * X_BOX_BYTES,
                                    RegFrag{s}, lane);
          }
        }
        // The dS tile is free once every warp has read the last Q tile's.
        if (qt > 0 || n > 0) named_sync(DS_FREE, CONSUMER_WGS * WG);
        if (sees) {
          // dP^T = V dO^T, then dS^T = P^T (dP^T + g_lse - delta) in its
          // place.
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) dp[i] = 0.f;
#pragma unroll 1
          for (int c = 0; c < CB; ++c)
            scores_box<1, 1, true>(dp, sv + c * X_BOX_BYTES, wrow, t + (CB + c) * X_BOX_BYTES,
                                   lane);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const size_t at = (size_t)bh * Sq + q_row(e);
            rv[e] = q_row(e) < Sq ? glse[at] - delta[at] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i)
            dp[i] = s[i] * (dp[i] + rv[2 * (i >> 2) + (i & 1)]);
        } else {
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) dp[i] = 0.f;
        }
        // dS^T into the dS tile (element i: Q row qr, key key0 + 8 ((i / 2)
        // % 2)), then dK += dS^T Q.
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) {
          const int qr = 8 * (i >> 2) + 2 * tq + (i & 1);
          ds_tile[qr * DQKV_KEYS + ((key0 + 8 * ((i >> 1) & 1)) ^ ds_swizzle(qr))] = dp[i];
        }
#pragma unroll
        for (int u = 0; u < NI; ++u) {
          const uint32_t bq = t + IB * u * X_BOX_BYTES;  // Q's boxes
          if constexpr (DK_STORED) {
            // The item's sum, plus the last Q tile's (unscaled), stored;
            // scaled after the last Q tile.
            float acc[16 * IB];
#pragma unroll
            for (int i = 0; i < 16 * IB; ++i) acc[i] = 0.f;
            if (sees)
              product_item<1, 4 * IB>(acc, bq, bq + (IB - 1) * X_BOX_BYTES, RegFrag{dp}, lane);
            if (qt > 0) add_stored<32 * IB>(acc, dk_head, D, key0, Sk, 32 * IB * u, lane);
            const float mul = qt == qtiles - 1 ? scale : 1.f;
            store_acc<32 * IB>(dk_head, D, acc, [mul](float v, int) { return mul * v; }, key0, Sk,
                               32 * IB * u, lane);
          } else if (sees) {
            product_item<1, 4 * IB>(dk_acc + 16 * IB * u, bq, bq + (IB - 1) * X_BOX_BYTES,
                                    RegFrag{dp}, lane);
          }
        }
        x.ring.release(it, lane);  // the last read of Q and dO
        named_sync(DS_FULL, CONSUMER_WGS * WG);

        // dQ = dS K: this warp's slab, Q rows [wrow, wrow + 16) of the tile
        // by columns [W wg, W wg + W), over the key halves that hold a key
        // (each half's sum from zero, added in fp32).
        float dq_acc[W / 2];
#pragma unroll
        for (int i = 0; i < W / 2; ++i) dq_acc[i] = 0.f;
        for (int kh = 0; kh < khalves; ++kh) {
          const uint32_t kb = x.res(n) + (kh * CB + W * wg / X_BOX) * X_BOX_BYTES;
          DsFrag frag = ds_frag0;
          frag.key0 += SEQ_TILE * kh;
          product_item<1, W / 8>(dq_acc, kb, kb + (W > X_BOX ? X_BOX_BYTES : 0), frag, lane,
                                 W * wg % X_BOX);
        }
        if (qt == qtiles - 1) release_resident(x.res_empty(n), lane);  // the last read of K
        store_acc<W>(dq + (size_t)bh * Sq * D, D, dq_acc,
                     [scale](float v, int) { return scale * v; }, q0 + frag_row, Sq, W * wg,
                     lane);
      }
      store_acc<D>(dv + (size_t)bh * Sk * D, D, dv_acc, [](float v, int) { return v; }, key0, Sk,
                   0, lane);
      if constexpr (!DK_STORED)
        store_acc<D>(dk_head, D, dk_acc, [scale](float v, int) { return scale * v; }, key0, Sk, 0,
                     lane);
    }
  }
}


// ---------------------------------------------------------------------------
// The wide-head backward: dQ (flash_dq_wide_3xtf32_kernel) and dK/dV
// (flash_dkv_wide_3xtf32_kernel) at any head dim D above 256 that is a
// multiple of X_BOX, the float32 calls of flash_attention_wide.cu. One
// kernel each, D a runtime argument: nothing stays resident, so shared
// memory is the same at every D.
// ---------------------------------------------------------------------------

// Shared memory of the wide-head backward, byte offsets from a 1024-aligned
// base: a ring of STAGES stages of four boxes (32 KB) that every operand
// streams through, each warp pair's two 4 KB buffers (16 x 64 fp32 in
// fragment order: dQ's P and dS; dK/dV's P^T, and each warp's operand for
// its output items, the warpgroup 0 warp's in the first), then the ring's
// full/empty barriers. A score item holds column box c of the four operands (dQ: Q,
// K, dO, V; dK/dV: K, Q, V, dO), so that warpgroup wg reads its product's
// operands at boxes 2 wg and 2 wg + 1; an output item holds 64 columns (two
// boxes) for each consumer warpgroup, warpgroup wg's at boxes 2 wg and
// 2 wg + 1. Six stages: 230,496 B.
struct WideX {
  static constexpr int STAGE = 4 * X_BOX_BYTES;
  static constexpr int XCH_ALL = 2 * X_PAIRS * X_XCH_BYTES;
  static constexpr int STAGES = ((int)SMEM_LIMIT - 2048 - XCH_ALL) / STAGE;
  static constexpr int XCH = STAGES * STAGE;
  static constexpr int BAR = XCH + XCH_ALL;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= (int)SMEM_LIMIT, "wide 3xTF32 backward ring exceeds shared memory");
};
constexpr int WIDE_OUT = 256;                      // output columns of a warpgroup: 128 registers
constexpr int WIDE_ITEMS = WIDE_OUT / (2 * X_BOX);  // output items of a warpgroup's columns
// Q tiles whose P^T and dS^T the float32 wide dK/dV keeps in its scratch
// at once (2048 rows): 1 MiB a block, at most 132 MiB on 132 SMs at any Sq.
// Each chunk after the first costs a round trip of the partial sums, more
// on the H100 than its bytes suggest (PERF.md), so S <= 2048 takes one.
constexpr int WIDE_QCHUNK = 32;

// The producer's score item `it`: column box col of m0 (rows r0), m1 (r1),
// m2 (r0) and m3 (r1) of head bh.
__device__ __forceinline__ void load_wide_scores(const Ring<WideX::STAGE>& ring, int it,
                                                 const CUtensorMap* m0, const CUtensorMap* m1,
                                                 const CUtensorMap* m2, const CUtensorMap* m3,
                                                 int col, int r0, int r1, int bh) {
  const uint32_t tile = ring.fill(it, WideX::STAGE), bar = ring.bar(it);
  tma_load_3d(tile, m0, bar, col, r0, bh);
  tma_load_3d(tile + X_BOX_BYTES, m1, bar, col, r1, bh);
  tma_load_3d(tile + 2 * X_BOX_BYTES, m2, bar, col, r0, bh);
  tma_load_3d(tile + 3 * X_BOX_BYTES, m3, bar, col, r1, bh);
}

// The producer's output item `it`: columns [c0, c0 + 64) of m0 and
// [c1, c1 + 64) of m1, rows row of head bh; boxes that start past D are not
// loaded (their columns are never stored).
__device__ __forceinline__ void load_wide_outputs(const Ring<WideX::STAGE>& ring, int it,
                                                  const CUtensorMap* m0, int c0,
                                                  const CUtensorMap* m1, int c1, int row, int bh,
                                                  int D) {
  const int n = (c0 < D) + (c0 + X_BOX < D) + (c1 < D) + (c1 + X_BOX < D);
  const uint32_t tile = ring.fill(it, n * X_BOX_BYTES), bar = ring.bar(it);
  if (c0 < D) tma_load_3d(tile, m0, bar, c0, row, bh);
  if (c0 + X_BOX < D) tma_load_3d(tile + X_BOX_BYTES, m0, bar, c0 + X_BOX, row, bh);
  if (c1 < D) tma_load_3d(tile + 2 * X_BOX_BYTES, m1, bar, c1, row, bh);
  if (c1 + X_BOX < D) tma_load_3d(tile + 3 * X_BOX_BYTES, m1, bar, c1 + X_BOX, row, bh);
}

// The ring of the wide-head backward, set up by thread 0 before the block
// syncs; smem: the same base, generic.
__device__ __forceinline__ Ring<WideX::STAGE> wide_ring(unsigned char* smem_raw,
                                                        unsigned char** smem) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  *smem = smem_raw + (base - raw);
  const Ring<WideX::STAGE> ring = make_ring<WideX::STAGE>(base, WideX::BAR, WideX::STAGES);
  __syncthreads();
  return ring;
}

// dQ at head dim D > 256, persistent: a grid of one block per SM walks the
// work tiles (bh, 64 Q rows, pass of 512 output columns) and loops over the
// key tiles their rows can see; the pair design of dq_pair with every
// operand streamed. Per key tile: D / 32 score items, in which the
// warpgroup 0 warp of pair p sums S = Q K^T and the warpgroup 1 warp dP =
// dO V^T over its 16 rows; P to the partner through the pair's buffer,
// which forms dS = P (dP + g_lse - delta) into the second; then WIDE_ITEMS
// output items, warpgroup wg adding dS K to dQ's columns [512 pass +
// 256 wg, + 256) (128 registers), dS read from the buffer by both. At
// D <= 512 one pass: the three products, each once. dq = scale * sum_j dS_j
// K_j, [BH, Sq, D] fp32.
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dq_wide_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dq,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const float* __restrict__ glse, int BH, int Sq, int Sk, int D,
                            float scale, int causal, int q_offset, int k_offset) {
  // Beside dQ's 128 registers, the score product sums in two groups of
  // n-tiles one k-step at a time and so does the output product: the
  // fastest choice without spills on the H100 (variants built side by
  // side; PERF.md).
  constexpr int S_NG = 2, S_KS = 1, P_UNROLL = 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  const Ring<WideX::STAGE> ring = wide_ring(smem_raw, &smem);
  const int CB = D / X_BOX;
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int passes = (D + 2 * WIDE_OUT - 1) / (2 * WIDE_OUT);
  // Work tile w: pass w % passes, Q tile (w / passes) % qtiles, head
  // w / (passes qtiles); neighbours share a head's K and V in L2.
  const int nwork = BH * qtiles * passes;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per key tile its score items, then its output
    // items (K).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int pass = w % passes;
        const int q0 = (w / passes) % qtiles * SEQ_TILE, bh = w / (passes * qtiles);
        const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * SEQ_TILE;
#pragma unroll 1
          for (int c = 0; c < CB; ++c, ++it)
            load_wide_scores(ring, it, &tm_q, &tm_k, &tm_do, &tm_v, X_BOX * c, q0, k0, bh);
#pragma unroll 1
          for (int u = 0; u < WIDE_ITEMS; ++u, ++it) {
            const int col = 2 * WIDE_OUT * pass + 2 * X_BOX * u;
            load_wide_outputs(ring, it, &tm_k, col, &tm_k, col + WIDE_OUT, k0, bh, D);
          }
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
    float4* const pt4 = reinterpret_cast<float4*>(smem + WideX::XCH + 2 * pair * X_XCH_BYTES);
    float4* const ds4 = pt4 + SEQ_TILE / 8 * 32;  // the pair's second buffer
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int pass = w % passes;
      const int q0 = (w / passes) % qtiles * SEQ_TILE, bh = w / (passes * qtiles);
      const int row0 = q0 + r;                                  // and row0 + 8
      const int col0 = 2 * WIDE_OUT * pass + WIDE_OUT * wg;  // this warpgroup's dQ columns
      const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
      float acc[WIDE_OUT / 2];  // dQ: the pair's 16 rows by this warpgroup's 256 columns
#pragma unroll
      for (int i = 0; i < WIDE_OUT / 2; ++i) acc[i] = 0.f;

      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * SEQ_TILE;
        // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), 16 x 64.
        float s[SEQ_TILE / 2];
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
        for (int c = 0; c < CB; ++c, ++it) {
          const uint32_t a = ring.tile(it) + 2 * wg * X_BOX_BYTES;
          ring.wait(it);
          scores_box<S_NG, S_KS>(s, a, X_PAIR_ROWS * pair, a + X_BOX_BYTES, lane);
          ring.release(it, lane);
        }
        // This thread's two rows: lse log2(e) for warpgroup 0, g_lse - delta
        // for warpgroup 1 (read here, not held through the score product).
        // Rows past Sq get lse = LSE_MASKED: their P is 0.
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

        // P to the partner in fragment order (float4 j * 32 + lane: a0..a3
        // of k-step j), which forms dS = P (dP + g_lse - delta) into the
        // pair's second buffer in the same order; each warp then reads its
        // product's A fragments there (the partner's lane wrote the same
        // fragment), so that its scores are not live through the products.
        // Keys past Sk read zero rows of K but get P = 0.
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
            s[i] = pv;
          }
#pragma unroll
          for (int j = 0; j < SEQ_TILE / 8; ++j)
            pt4[j * 32 + lane] = make_float4(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
          __threadfence_block();
          named_arrive(XCH_FULL + pair, 64);
          named_sync(XCH_BACK + pair, 64);  // dS is in the second buffer
        } else {
          named_sync(XCH_FULL + pair, 64);
#pragma unroll
          for (int j = 0; j < SEQ_TILE / 8; ++j) {
            const float4 p = pt4[j * 32 + lane];
            ds4[j * 32 + lane] =
                make_float4(p.x * (s[4 * j] + rv[0]), p.y * (s[4 * j + 2] + rv[1]),
                            p.z * (s[4 * j + 1] + rv[0]), p.w * (s[4 * j + 3] + rv[1]));
          }
          __threadfence_block();
          named_arrive(XCH_BACK + pair, 64);
        }

        // dQ += dS K over this warpgroup's halves of the output items; an
        // item's columns past D are skipped (not loaded, not stored).
#pragma unroll
        for (int u = 0; u < WIDE_ITEMS; ++u, ++it) {
          ring.wait(it);
          if (col0 + 2 * X_BOX * u < D) {
            const uint32_t b = ring.tile(it) + 2 * wg * X_BOX_BYTES;
            product_item<1>(acc + 32 * u, b, b + X_BOX_BYTES, SmemFrag<P_UNROLL>{ds4, lane},
                            lane);
          }
          ring.release(it, lane);
        }
      }
      store_acc<WIDE_OUT>(dq + (size_t)bh * Sq * D, D, acc,
                          [scale](float x, int) { return scale * x; }, row0, Sq, col0, lane,
                          D - col0);
    }
  }
}

// dK/dV at head dim D > 256, persistent: a grid of one block per SM walks
// the work tiles (bh, 64 keys) and the Q tiles that can see the keys in
// chunks of WIDE_QCHUNK, each in two phases; the pair design of dkv_pair
// with every operand streamed. Scores, once: per Q tile D / 32 score
// items, in which the warpgroup 0 warp of pair p sums S^T = K Q^T and the
// warpgroup 1 warp dP^T = V dO^T over its 16 keys; P^T to the partner,
// which forms dS^T = P^T (dP^T + g_lse - delta); each warp keeps its output
// product's operand (P^T or dS^T, 4 KB in fragment order) in the block's
// scratch. Outputs, in passes of 256 columns: per Q tile the warp copies
// its operand back into its own 4 KB of shared memory, then WIDE_ITEMS
// output items: dV += P^T dO (warpgroup 0) and dK += dS^T Q (warpgroup 1),
// 128 registers each; after the first chunk each thread adds the sums it
// stored unscaled to dV and dK, the last chunk's scaled. Every product runs
// once at any D, where forming S^T and dP^T again in each pass would cost
// 1.5x the products at D = 512 (2.5x at D = 1024). The scratch (from the
// wrapper): per block of the grid, per Q tile of a chunk, 8 warps x 4 KB.
// dV = sum_i P_ij^T dO_i, dK = scale * sum_i dS_ij^T Q_i, [BH, Sk, D] fp32.
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_dkv_wide_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do, float* __restrict__ dk,
                             float* __restrict__ dv, float4* __restrict__ scratch,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const float* __restrict__ glse, int BH, int Sq, int Sk, int D,
                             float scale, int causal, int q_offset, int k_offset) {
  // The score product (no accumulator beside it) sums in one group of
  // n-tiles with its four k-steps unrolled; the output product in two
  // groups reading four k-steps ahead: the fastest choice without spills on
  // the H100 (variants built side by side; PERF.md).
  constexpr int S_NG = 1, S_KS = 4, P_NG = 2, P_UNROLL = 4;
  constexpr int FRAG = SEQ_TILE / 8 * 32;  // float4 of a warp's 16 x 64 operand
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  const Ring<WideX::STAGE> ring = wide_ring(smem_raw, &smem);
  const int CB = D / X_BOX;
  const int ktiles = (Sk + SEQ_TILE - 1) / SEQ_TILE;
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int passes = (D + WIDE_OUT - 1) / WIDE_OUT;
  const int chunk = min(qtiles, WIDE_QCHUNK);
  // Work tile w: key tile w % ktiles of head w / ktiles; neighbours share a
  // head's Q and dO in L2.
  const int nwork = BH * ktiles;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile every Q tile's score items, then
    // per pass every Q tile's output items (dO and Q).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int k0 = w % ktiles * SEQ_TILE, bh = w / ktiles;
        const int qt0 = first_query_tile(k0, causal, q_offset, k_offset);
        for (int c0 = qt0; c0 < qtiles; c0 += WIDE_QCHUNK) {
          const int c1 = min(c0 + WIDE_QCHUNK, qtiles);
          for (int qt = c0; qt < c1; ++qt) {
#pragma unroll 1
            for (int c = 0; c < CB; ++c, ++it)
              load_wide_scores(ring, it, &tm_k, &tm_q, &tm_v, &tm_do, X_BOX * c, k0,
                               qt * SEQ_TILE, bh);
          }
          for (int pass = 0; pass < passes; ++pass)
            for (int qt = c0; qt < c1; ++qt) {
#pragma unroll 1
              for (int u = 0; u < WIDE_ITEMS; ++u, ++it) {
                const int col = WIDE_OUT * pass + 2 * X_BOX * u;
                load_wide_outputs(ring, it, &tm_do, col, &tm_q, col, qt * SEQ_TILE, bh, D);
              }
            }
        }
      }
    }
  } else {
    // Consumer warp: pair p = warp % 4 owns keys [16 p, 16 p + 16) of the
    // work tile; warpgroup 0 computes S^T, P^T and dV, warpgroup 1 dP^T,
    // dS^T and dK.
    reg_alloc<CONSUMER_REGS>();
    const int warp = threadIdx.x / 32;
    const int pair = warp % X_PAIRS;
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int r = X_PAIR_ROWS * pair + (lane >> 2);  // this thread's keys r, r + 8 of the 64
    const float sl2 = scale * LOG2E;
    float4* const pt4 = reinterpret_cast<float4*>(smem + WideX::XCH + 2 * pair * X_XCH_BYTES);
    // The warp's own 4 KB of the pair's buffers (P^T's for warpgroup 0),
    // into which it copies its operand for the output items: each lane
    // reads back only what it wrote.
    float4* const own = pt4 + wg * FRAG;
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int k0 = w % ktiles * SEQ_TILE, bh = w / ktiles;
      const int key0 = k0 + r;  // and key0 + 8
      const int qt0 = first_query_tile(k0, causal, q_offset, k_offset);
      // The warp's operand of Q tile qt of the chunk from c0 in the scratch
      // (chunk Q tiles a block, as wide_dkv_scratch_bytes counts them).
      auto operand = [&](int qt, int c0) {
        return scratch + ((size_t)(blockIdx.x * chunk + qt - c0) * CONSUMER_WARPS + warp) * FRAG;
      };
      // One chunk at least, so that keys no Q tile sees get dK = dV = 0.
      for (int c0 = qt0;; c0 += WIDE_QCHUNK) {
        const int c1 = min(c0 + WIDE_QCHUNK, qtiles);
        for (int qt = c0; qt < c1; ++qt) {
          const int q0 = qt * SEQ_TILE;
          // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 16 x 64.
          float s[SEQ_TILE / 2];
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) s[i] = 0.f;
          for (int c = 0; c < CB; ++c, ++it) {
            const uint32_t a = ring.tile(it) + 2 * wg * X_BOX_BYTES;
            ring.wait(it);
            scores_box<S_NG, S_KS>(s, a, X_PAIR_ROWS * pair, a + X_BOX_BYTES, lane);
            ring.release(it, lane);
          }

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
          // lane: a0..a3 of k-step j), which forms dS^T in the same order;
          // each writes its own to the scratch. Keys past Sk are never
          // written, so they need no mask. The warpgroup 0 warp waits for
          // the partner's read before its buffer is reused.
          float4* const out = operand(qt, c0);
          if (wg == 0) {
            const bool mask = causal && q_offset + q0 < k_offset + k0 + SEQ_TILE - 1;
#pragma unroll
            for (int i = 0; i < SEQ_TILE / 2; ++i) {
              const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
              float pv = exp2f(fmaf(s[i], sl2, -rv[2 * (i >> 2) + (i & 1)]));
              if (mask && q_offset + q0 + c < k_offset + key0 + 8 * ((i >> 1) & 1)) pv = 0.f;
              s[i] = pv;
            }
#pragma unroll
            for (int j = 0; j < SEQ_TILE / 8; ++j) {
              const float4 f = make_float4(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
              pt4[j * 32 + lane] = f;
              out[j * 32 + lane] = f;
            }
            __threadfence_block();
            named_arrive(XCH_FULL + pair, 64);
            named_sync(XCH_BACK + pair, 64);
          } else {
            named_sync(XCH_FULL + pair, 64);
#pragma unroll
            for (int j = 0; j < SEQ_TILE / 8; ++j) {
              const float4 p = pt4[j * 32 + lane];
              out[j * 32 + lane] = make_float4(
                  p.x * (s[4 * j] + rv[2 * j]), p.y * (s[4 * j + 2] + rv[2 * j]),
                  p.z * (s[4 * j + 1] + rv[2 * j + 1]), p.w * (s[4 * j + 3] + rv[2 * j + 1]));
            }
            __threadfence_block();
            named_arrive(XCH_BACK + pair, 64);
          }
        }

        for (int pass = 0; pass < passes; ++pass) {
          const int col0 = WIDE_OUT * pass;
          float acc[WIDE_OUT / 2];  // dV or dK: the pair's 16 keys by the pass's 256 columns
#pragma unroll
          for (int i = 0; i < WIDE_OUT / 2; ++i) acc[i] = 0.f;
          for (int qt = c0; qt < c1; ++qt) {
            {
              const float4* const in = operand(qt, c0);
              float4 f[SEQ_TILE / 8];
#pragma unroll
              for (int j = 0; j < SEQ_TILE / 8; ++j) f[j] = in[j * 32 + lane];
#pragma unroll
              for (int j = 0; j < SEQ_TILE / 8; ++j) own[j * 32 + lane] = f[j];
            }
            // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1) over
            // the output items; columns past D are skipped.
#pragma unroll
            for (int u = 0; u < WIDE_ITEMS; ++u, ++it) {
              ring.wait(it);
              if (col0 + 2 * X_BOX * u < D) {
                const uint32_t b = ring.tile(it) + 2 * wg * X_BOX_BYTES;
                product_item<P_NG>(acc + 32 * u, b, b + X_BOX_BYTES,
                                   SmemFrag<P_UNROLL>{own, lane}, lane);
              }
              ring.release(it, lane);
            }
          }
          float* const o = (wg == 0 ? dv : dk) + (size_t)bh * Sk * D;
          if (c0 != qt0) add_stored<WIDE_OUT>(acc, o, D, key0, Sk, col0, lane, D - col0);
          const float mul = wg == 0 || c1 < qtiles ? 1.f : scale;
          store_acc<WIDE_OUT>(o, D, acc, [mul](float x, int) { return mul * x; }, key0, Sk, col0,
                              lane, D - col0);
        }
        if (c1 == qtiles) break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The forwards: flash_fwd_3xtf32_kernel<D> (the multi-tile route: an online
// softmax over key tiles of 64) and flash_fwd_single_3xtf32_kernel<D> (Sk
// at most 128: one key tile of 128, the direct softmax). One body,
// fwd_3xtf32<D, BK>, serves both.
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 2 * SEQ_TILE;  // Q rows of a forward work tile: 64 a warpgroup

// Shared memory of the forward at head dim D and key tile BK, byte offsets
// from a 1024-aligned base: the Q buffers (a 128-row tile as 64 x 32 boxes,
// the rows of warpgroup h in column box c at box h D / 32 + c; two, so that
// the next work tile's Q loads while this one runs, where they leave room
// for 8 ring stages), each consumer warp's P buffer (16 x BK fp32 in
// fragment order, where P_SMEM), the ring of one-box stages that K and V
// stream through (as many as fit, at most 16), then the ring's full/empty
// barriers and the Q buffers' full/empty barriers.
template <int D, int BK>
struct FwdX {
  static constexpr int CB = D / X_BOX;                 // column boxes
  static constexpr int TILE_Q = 2 * CB * X_BOX_BYTES;  // 16, 32, 64 or 128 KB
  // Where O and the scores leave P's registers no room beside them (D = 256,
  // and the single-tile tile of 128 keys at D = 128), each consumer warp
  // hands P to its output products through a buffer of its own.
  static constexpr bool P_SMEM = D / 2 + BK / 2 >= 128;
  static constexpr int P_BUF = P_SMEM ? X_PAIR_ROWS * BK * 4 : 0;  // a warp's
  static constexpr int AVAIL = (int)SMEM_LIMIT - 2048 - CONSUMER_WARPS * P_BUF;
  static constexpr int QBUFS = 2 * TILE_Q + 8 * X_BOX_BYTES <= AVAIL ? 2 : 1;
  static constexpr int P = QBUFS * TILE_Q;                 // + warp * P_BUF
  static constexpr int RING = P + CONSUMER_WARPS * P_BUF;
  static constexpr int FIT = (AVAIL - QBUFS * TILE_Q) / X_BOX_BYTES;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr int BAR = RING + STAGES * X_BOX_BYTES;
  static constexpr int BYTES = BAR + (2 * STAGES + 2 * QBUFS) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= (int)SMEM_LIMIT, "forward tiles exceed shared memory");
};

// The softmax of one key tile on a consumer thread's registers: the scores
// s (KH 16 x 64 accumulator tiles; s[kb][i] is row row0 + 8 ((i / 2) % 2),
// key k0 + 64 kb + 8 (i / 4) + 2 tq + i % 2) become P in fp32, in place;
// the running max m (log2 units, from NEG_INF), the running max of the raw
// scores mr (lse's, from -inf) and the partial row sums l move on. ONLINE:
// corr is the factor that rescales O and l; else the tile is the only one
// and the softmax is the direct one. MASK: the tile holds keys past Sk or
// causally hidden keys for some of the rows. The scale folds into one FMA
// before exp2.
template <int KH, bool MASK, bool ONLINE>
__device__ __forceinline__ void softmax_f32(float (&s)[KH][SEQ_TILE / 2], float (&m)[2],
                                            float (&mr)[2], float (&l)[2], float (&corr)[2],
                                            int row0, int k0, int Sk, float sl2, int causal,
                                            int q_offset, int k_offset, int tq) {
  auto hidden = [&](int kb, int i) {
    const int kj = k0 + SEQ_TILE * kb + 8 * (i >> 2) + 2 * tq + (i & 1);
    return kj >= Sk || (causal && q_offset + row0 + 8 * ((i >> 1) & 1) < k_offset + kj);
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kb = 0; kb < KH; ++kb)
#pragma unroll
    for (int i = 0; i < SEQ_TILE / 2; ++i)
      if (!MASK || !hidden(kb, i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[kb][i]);
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mr[h] = fmaxf(mr[h], mx[h]);
    const float m_new = fmaxf(m[h], mx[h] * sl2);  // m starts at NEG_INF (finite)
    if (ONLINE) {
      corr[h] = exp2f(m[h] - m_new);
      l[h] *= corr[h];
    }
    m[h] = m_new;
    neg_m[h] = -m_new;
  }
#pragma unroll
  for (int kb = 0; kb < KH; ++kb)
#pragma unroll
    for (int i = 0; i < SEQ_TILE / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(s[kb][i], sl2, neg_m[h]));
      if (MASK && hidden(kb, i)) p = 0.f;
      s[kb][i] = p;
      l[h] += p;
    }
}

// The forward's work, persistent: a grid of one block per SM walks the work
// tiles (bh, 128 Q rows) and loops over the key tiles of BK keys (64, or
// 128 in one tile: the single-tile forward) their rows can see. Each
// consumer warp owns 16 rows of the work tile across all D columns: per key
// tile S = Q K^T (scores_box per 32-column box of K, each box's sum from
// zero), the softmax in registers, O += P V (product_item per 64-key half
// and 64 output columns, P split from the accumulator fragment), O in
// registers (D / 2 a thread). o [BH, Sq, D] and lse [BH, Sq], fp32.
template <int D, int BK>
__device__ __forceinline__ void fwd_3xtf32(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, float* __restrict__ o,
                                           float* __restrict__ lse, int BH, int Sq, int Sk,
                                           float scale, int causal, int q_offset, int k_offset) {
  using L = FwdX<D, BK>;
  constexpr int CB = L::CB;
  constexpr int KH = BK / SEQ_TILE;    // 64-key halves of a key tile
  constexpr int NB = CB < 2 ? CB : 2;  // V boxes of an output item: 64 columns (32 at D = 32)
  constexpr int NU = CB / NB;          // output items across D
  constexpr bool ONLINE = KH == 1;
  // Beside 128 registers of O and the scores (P_SMEM), the products sum in
  // groups of n-tiles with fewer k-steps unrolled, as dK/dV does beside dV
  // or dK: the score product in four groups at D = 256 and in two with one
  // k-step unrolled in the single-tile forward at D = 128 (the fastest of
  // the choices without spills on the H100; PERF.md), the output product
  // in two.
  constexpr bool HEAVY = L::P_SMEM;
  constexpr int S_NG = D == 256 ? 4 : HEAVY ? 2 : 1;
  constexpr int S_KS = D == 256 ? 2 : HEAVY ? 1 : 4;
  constexpr int P_NG = HEAVY ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Ring<X_BOX_BYTES> ring =
      make_ring<X_BOX_BYTES>(base + L::RING, L::BAR - L::RING, L::STAGES);
  const uint32_t q_full = base + L::BAR + 16 * L::STAGES;  // buffer b at + 8 b
  const uint32_t q_empty = q_full + 8 * L::QBUFS;          // buffer b at + 8 b
  if (threadIdx.x == 0) {
    for (int b = 0; b < L::QBUFS; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int qtiles = (Sq + F_ROWS - 1) / F_ROWS;
  const int nwork = BH * qtiles;  // work tile w: Q tile w % qtiles of head w / qtiles
  // 64-key halves of a key tile that hold keys: a box wholly past Sk is
  // never loaded (the single-tile forward at Sk <= 64).
  const int nh = KH == 1 ? 1 : min(KH, (Sk + SEQ_TILE - 1) / SEQ_TILE);
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work tile its Q (the 64-row halves that
    // hold rows), then per key tile its score items (K boxes: column box c,
    // key half kb) and its output items (V boxes: output item u, key half
    // kb, box b).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
        const int q0 = w % qtiles * F_ROWS, bh = w / qtiles;
        const int qh = min(2, (Sq - q0 + SEQ_TILE - 1) / SEQ_TILE);
        const int qb = n % L::QBUFS;
        const uint32_t bar = q_full + 8 * qb;
        mbar_wait(q_empty + 8 * qb, ((n / L::QBUFS) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, qh * CB * X_BOX_BYTES);
        // The loops stay rolled: unrolled, they spill in the producer's 24
        // registers.
#pragma unroll 1
        for (int h = 0; h < qh; ++h)
#pragma unroll 1
          for (int c = 0; c < CB; ++c)
            tma_load_3d(base + qb * L::TILE_Q + (h * CB + c) * X_BOX_BYTES, tm_q, bar, X_BOX * c,
                        q0 + SEQ_TILE * h, bh);
        const int nk = key_tiles<F_ROWS, BK>(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * BK;
#pragma unroll 1
          for (int c = 0; c < CB; ++c)
#pragma unroll 1
            for (int kb = 0; kb < nh; ++kb, ++it)
              tma_load_3d(ring.fill(it, X_BOX_BYTES), tm_k, ring.bar(it), X_BOX * c,
                          k0 + SEQ_TILE * kb, bh);
#pragma unroll 1
          for (int u = 0; u < NU; ++u)
#pragma unroll 1
            for (int kb = 0; kb < nh; ++kb)
#pragma unroll 1
              for (int b = 0; b < NB; ++b, ++it)
                tma_load_3d(ring.fill(it, X_BOX_BYTES), tm_v, ring.bar(it), X_BOX * (NB * u + b),
                            k0 + SEQ_TILE * kb, bh);
        }
      }
    }
  } else {
    // Consumer warp: rows [16 (warp % 4), + 16) of warpgroup wg's 64.
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int wrow = X_PAIR_ROWS * (threadIdx.x / 32 % 4);
    const float sl2 = scale * LOG2E;
    float4* const pbuf =
        reinterpret_cast<float4*>(smem_raw + (base - smem_u32(smem_raw)) + L::P) +
        threadIdx.x / 32 * (L::P_BUF / 16);  // this warp's P (P_SMEM)
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++n) {
      const int q0 = w % qtiles * F_ROWS, bh = w / qtiles;
      const int row_first = q0 + SEQ_TILE * wg + wrow;  // this warp's first row
      const int row0 = row_first + (lane >> 2);         // this thread's rows row0, row0 + 8
      // A warp whose rows are all past Sq (its Q box may not have been
      // loaded) only waits for and releases the items.
      const bool active = row_first < Sq;
      const int qb = n % L::QBUFS;
      const uint32_t sq = base + qb * L::TILE_Q + wg * CB * X_BOX_BYTES;  // box c at + c boxes
      const int nk = key_tiles<F_ROWS, BK>(q0, Sq, Sk, causal, q_offset, k_offset);
      float acc[D / 2];  // O: the warp's 16 rows by D columns
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      mbar_wait(q_full + 8 * qb, (n / L::QBUFS) & 1);
      if (nk == 0) release_resident(q_empty + 8 * qb, lane);

      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        // Causal: the warp's rows may see no key of this tile.
        const bool sees = active && !(causal && q_offset + row_first + 15 < k_offset + k0);
        // S = Q K^T, 16 x BK.
        float s[KH][SEQ_TILE / 2];
#pragma unroll
        for (int kb = 0; kb < KH; ++kb)
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) s[kb][i] = 0.f;
#pragma unroll 1
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int kb = 0; kb < KH; ++kb) {
            if (kb >= nh) continue;
            ring.wait(it);
            if (sees)
              scores_box<S_NG, S_KS>(s[kb], sq + c * X_BOX_BYTES, wrow, ring.tile(it), lane);
            ring.release(it, lane);
            ++it;
          }
        if (kt == nk - 1) release_resident(q_empty + 8 * qb, lane);  // the last read of this Q

        if (sees) {
          float corr[2];
          if (k0 + BK > Sk || (causal && q_offset + row_first < k_offset + k0 + BK - 1))
            softmax_f32<KH, true, ONLINE>(s, m, mr, l, corr, row0, k0, Sk, sl2, causal, q_offset,
                                          k_offset, tq);
          else
            softmax_f32<KH, false, ONLINE>(s, m, mr, l, corr, row0, k0, Sk, sl2, causal,
                                           q_offset, k_offset, tq);
          if (ONLINE) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
          }
          if (L::P_SMEM) {  // the last key tile's products have read it
#pragma unroll
            for (int kb = 0; kb < KH; ++kb)
#pragma unroll
              for (int j = 0; j < SEQ_TILE / 8; ++j)
                pbuf[(SEQ_TILE / 8 * kb + j) * 32 + lane] = make_float4(
                    s[kb][4 * j], s[kb][4 * j + 2], s[kb][4 * j + 1], s[kb][4 * j + 3]);
          }
        }

        // O += P V, per output item (64 columns) and 64-key half.
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int kb = 0; kb < KH; ++kb) {
            if (kb >= nh) continue;
            ring.wait(it);
            if (NB == 2) ring.wait(it + 1);
            if (sees && L::P_SMEM)
              product_item<P_NG, 4 * NB>(acc + 16 * NB * u, ring.tile(it), ring.tile(it + NB - 1),
                                         SmemFrag<2>{pbuf + SEQ_TILE / 8 * 32 * kb, lane}, lane);
            else if (sees)
              product_item<P_NG, 4 * NB>(acc + 16 * NB * u, ring.tile(it),
                                         ring.tile(it + NB - 1), RegFrag{s[kb]}, lane);
            ring.release(it, lane);
            if (NB == 2) ring.release(it + 1, lane);
            it += NB;
          }
      }

      // O / l and lse = max s scale + log(l) from registers; a row that saw
      // no key gets O = 0 and lse = LSE_MASKED.
      if (active) {
        float div[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          const bool empty = l[h] == 0.f;
          div[h] = empty ? 1.f : l[h];
          const int qi = row0 + 8 * h;
          if (tq == 0 && qi < Sq)
            lse[(size_t)bh * Sq + qi] = empty ? LSE_MASKED : fmaf(mr[h], scale, logf(l[h]));
        }
        store_acc<D>(o + (size_t)bh * Sq * D, D, acc,
                     [&div](float x, int h) { return x / div[h]; }, row0, Sq, 0, lane);
      }
    }
  }
}

// The multi-tile forward: any Sq and Sk.
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                        float* __restrict__ lse, int BH, int Sq, int Sk, float scale, int causal,
                        int q_offset, int k_offset) {
  fwd_3xtf32<D, SEQ_TILE>(&tm_q, &tm_k, &tm_v, o, lse, BH, Sq, Sk, scale, causal, q_offset,
                          k_offset);
}

// The single-tile forward: Sq and Sk at most 128, one work tile a head.
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_single_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                               float* __restrict__ lse, int BH, int Sq, int Sk, float scale,
                               int causal, int q_offset, int k_offset) {
  fwd_3xtf32<D, F_ROWS>(&tm_q, &tm_k, &tm_v, o, lse, BH, Sq, Sk, scale, causal, q_offset,
                        k_offset);
}

// ---------------------------------------------------------------------------
// The wide-head forward (flash_fwd_wide_3xtf32_kernel) at any head dim D
// above 256 that is a multiple of X_BOX, the float32 call of
// flash_attention_wide.cu: the layout of the wide-head backward (WideX,
// nothing resident), the pair design of flash_dq_wide_3xtf32_kernel, and
// the forward's online softmax (softmax_f32).
// ---------------------------------------------------------------------------

// The producer's score item `it` of the wide forward: column box c0 of Q
// (rows q0) and of K (rows k0), warpgroup 0's, then column box c1 of each,
// warpgroup 1's, where c1 < CB (else not loaded).
__device__ __forceinline__ void load_fwd_wide_scores(const Ring<WideX::STAGE>& ring, int it,
                                                     const CUtensorMap* q, const CUtensorMap* k,
                                                     int c0, int c1, int CB, int q0, int k0,
                                                     int bh) {
  const bool two = c1 < CB;
  const uint32_t tile = ring.fill(it, (two ? 4 : 2) * X_BOX_BYTES), bar = ring.bar(it);
  tma_load_3d(tile, q, bar, X_BOX * c0, q0, bh);
  tma_load_3d(tile + X_BOX_BYTES, k, bar, X_BOX * c0, k0, bh);
  if (two) {
    tma_load_3d(tile + 2 * X_BOX_BYTES, q, bar, X_BOX * c1, q0, bh);
    tma_load_3d(tile + 3 * X_BOX_BYTES, k, bar, X_BOX * c1, k0, bh);
  }
}

// The forward at head dim D > 256, persistent: a grid of one block per SM
// walks the work tiles (bh, 64 Q rows, pass of 512 output columns) and
// loops over the key tiles their rows can see. Warp w of warpgroup 0 and
// warp w of warpgroup 1 (pair p = w) own the same 16 Q rows. Per key tile:
// ceil(D / 64) score items, in which warpgroup 0 sums S = Q K^T over the
// first ceil(D / 64) column boxes and warpgroup 1 over the rest (each box's
// sum from zero); the two partial sums cross through the pair's two 4 KB
// buffers (each warp writes its own, XCH_FULL + p: both are written), and
// each warp adds them in the same order, so that both hold the same S bit
// for bit and run the same online softmax on it; then, once the partner has
// read its partial sum (XCH_BACK + p), each warp writes its P to its own
// buffer in fragment order and adds P V to its warpgroup's 256 output
// columns [512 pass + 256 wg, + 256) (128 registers) over WIDE_ITEMS output
// items. At D <= 512 one pass: each product once. o [BH, Sq, D] and lse
// [BH, Sq] (written by the first pass), fp32.
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_wide_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                             float* __restrict__ lse, int BH, int Sq, int Sk, int D, float scale,
                             int causal, int q_offset, int k_offset) {
  // Beside O's 128 registers, the score product sums in two groups of
  // n-tiles one k-step at a time and the output product reads P one k-step
  // at a time, as in the wide dQ.
  constexpr int S_NG = 2, S_KS = 1, P_UNROLL = 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  const Ring<WideX::STAGE> ring = wide_ring(smem_raw, &smem);
  const int CB = D / X_BOX;
  const int CH = (CB + 1) / 2;  // score items: warpgroup 0's boxes [0, CH), 1's [CH, CB)
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  const int passes = (D + 2 * WIDE_OUT - 1) / (2 * WIDE_OUT);
  // Work tile w: pass w % passes, Q tile (w / passes) % qtiles, head
  // w / (passes qtiles); neighbours share a head's K and V in L2.
  const int nwork = BH * qtiles * passes;
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per key tile its score items (Q and K), then
    // its output items (V).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int it = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int pass = w % passes;
        const int q0 = (w / passes) % qtiles * SEQ_TILE, bh = w / (passes * qtiles);
        const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * SEQ_TILE;
#pragma unroll 1
          for (int c = 0; c < CH; ++c, ++it)
            load_fwd_wide_scores(ring, it, &tm_q, &tm_k, c, c + CH, CB, q0, k0, bh);
#pragma unroll 1
          for (int u = 0; u < WIDE_ITEMS; ++u, ++it) {
            const int col = 2 * WIDE_OUT * pass + 2 * X_BOX * u;
            load_wide_outputs(ring, it, &tm_v, col, &tm_v, col + WIDE_OUT, k0, bh, D);
          }
        }
      }
    }
  } else {
    // Consumer warp: pair p = warp % 4 owns rows [16 p, 16 p + 16) of the
    // work tile; warpgroup wg sums S over its column boxes and holds O for
    // its 256 columns.
    reg_alloc<CONSUMER_REGS>();
    const int pair = (threadIdx.x / 32) % X_PAIRS;
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const float sl2 = scale * LOG2E;
    float* const mine = reinterpret_cast<float*>(smem + WideX::XCH + (2 * pair + wg) * X_XCH_BYTES);
    const float* const theirs =
        reinterpret_cast<const float*>(smem + WideX::XCH + (2 * pair + 1 - wg) * X_XCH_BYTES);
    int it = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int pass = w % passes;
      const int q0 = (w / passes) % qtiles * SEQ_TILE, bh = w / (passes * qtiles);
      const int row_first = q0 + X_PAIR_ROWS * pair;  // the pair's first row
      const int row0 = row_first + (lane >> 2);       // this thread's rows row0, row0 + 8
      const int col0 = 2 * WIDE_OUT * pass + WIDE_OUT * wg;  // this warpgroup's O columns
      const int nk = key_tiles(q0, Sq, Sk, causal, q_offset, k_offset);
      // A pair whose rows are all past Sq only waits for and releases the
      // items (both warps alike, so the pair's barriers stay matched).
      const bool active = row_first < Sq;
      float acc[WIDE_OUT / 2];  // O: the pair's 16 rows by this warpgroup's 256 columns
#pragma unroll
      for (int i = 0; i < WIDE_OUT / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * SEQ_TILE;
        // Causal: the pair's rows may see no key of this tile.
        const bool sees = active && !(causal && q_offset + row_first + 15 < k_offset + k0);
        // This warp's partial S = Q K^T over its column boxes, 16 x 64.
        float s[1][SEQ_TILE / 2];
#pragma unroll
        for (int i = 0; i < SEQ_TILE / 2; ++i) s[0][i] = 0.f;
        for (int c = 0; c < CH; ++c, ++it) {
          const uint32_t a = ring.tile(it) + 2 * wg * X_BOX_BYTES;
          ring.wait(it);
          if (sees && (wg == 0 || c + CH < CB))
            scores_box<S_NG, S_KS>(s[0], a, X_PAIR_ROWS * pair, a + X_BOX_BYTES, lane);
          ring.release(it, lane);
        }

        if (sees) {
          // The partial sums cross; both warps add first half + second half.
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) mine[i * 32 + lane] = s[0][i];
          __threadfence_block();
          named_sync(XCH_FULL + pair, 64);
#pragma unroll
          for (int i = 0; i < SEQ_TILE / 2; ++i) {
            const float x = theirs[i * 32 + lane];
            s[0][i] = wg == 0 ? s[0][i] + x : x + s[0][i];
          }
          float corr[2];
          if (k0 + SEQ_TILE > Sk || (causal && q_offset + row_first < k_offset + k0 + SEQ_TILE - 1))
            softmax_f32<1, true, true>(s, m, mr, l, corr, row0, k0, Sk, sl2, causal, q_offset,
                                       k_offset, tq);
          else
            softmax_f32<1, false, true>(s, m, mr, l, corr, row0, k0, Sk, sl2, causal, q_offset,
                                        k_offset, tq);
#pragma unroll
          for (int i = 0; i < WIDE_OUT / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
          // P to this warp's own buffer in fragment order (float4 j * 32 +
          // lane: a0..a3 of k-step j), once the partner has read the partial
          // sum there, so that the scores are not live through the products.
          named_sync(XCH_BACK + pair, 64);
          float4* const p4 = reinterpret_cast<float4*>(mine);
#pragma unroll
          for (int j = 0; j < SEQ_TILE / 8; ++j)
            p4[j * 32 + lane] =
                make_float4(s[0][4 * j], s[0][4 * j + 2], s[0][4 * j + 1], s[0][4 * j + 3]);
          __syncwarp();
        }

        // O += P V over this warpgroup's halves of the output items; an
        // item's columns past D are skipped (not loaded, not stored).
#pragma unroll
        for (int u = 0; u < WIDE_ITEMS; ++u, ++it) {
          ring.wait(it);
          if (sees && col0 + 2 * X_BOX * u < D) {
            const uint32_t b = ring.tile(it) + 2 * wg * X_BOX_BYTES;
            product_item<1>(acc + 32 * u, b, b + X_BOX_BYTES,
                            SmemFrag<P_UNROLL>{reinterpret_cast<const float4*>(mine), lane},
                            lane);
          }
          ring.release(it, lane);
        }
      }

      // O / l and lse = max s scale + log(l) from registers; a row that saw
      // no key gets O = 0 and lse = LSE_MASKED.
      if (active) {
        float div[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          const bool empty = l[h] == 0.f;
          div[h] = empty ? 1.f : l[h];
          const int qi = row0 + 8 * h;
          if (pass == 0 && wg == 0 && tq == 0 && qi < Sq)
            lse[(size_t)bh * Sq + qi] = empty ? LSE_MASKED : fmaf(mr[h], scale, logf(l[h]));
        }
        store_acc<WIDE_OUT>(o + (size_t)bh * Sq * D, D, acc,
                            [&div](float x, int h) { return x / div[h]; }, row0, Sq, col0, lane,
                            D - col0);
      }
    }
  }
}

// The tensor map of a contiguous [BH, S, D] fp32 tensor in 64-row x
// 32-column boxes (128-byte rows, the 128 B swizzle); rows past S read as
// zeros.
int x_map(CUtensorMap* map, const void* base, int S, int BH, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)X_BOX, (cuuint32_t)SEQ_TILE, 1};
  return make_map<float>(map, base, 3, dims, strides, box, X_BOX * 4);
}

// The backward's four operands' tensor maps at head dim D and a persistent
// grid of min(nwork, SMs) blocks.
int x_setup(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
            int BH, int Sq, int Sk, int D, int nwork, dim3* grid) {
  int err, sms = 0;
  if ((err = x_map(&m[0], q, Sq, BH, D)) || (err = x_map(&m[1], k, Sk, BH, D)) ||
      (err = x_map(&m[2], v, Sk, BH, D)) || (err = x_map(&m[3], dout, Sq, BH, D)) ||
      (err = sm_count(&sms)))
    return err;
  *grid = dim3(nwork < sms ? nwork : sms);
  return 0;
}

// dQ's launch at head dim D: work tiles of the design's rows.
template <int D>
int launch_dq_x(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* glse, void* dq, int BH, int Sq, int Sk,
                float scale, int causal, int qo, int ko, cudaStream_t stream) {
  using L = BwdX<D>;
  CUtensorMap m[4];
  dim3 grid;
  const int err =
      x_setup(m, q, k, v, dout, BH, Sq, Sk, D, BH * ((Sq + L::ROWS - 1) / L::ROWS), &grid);
  if (err) return err;
  return launch(flash_dq_3xtf32_kernel<D>, grid, SM90_THREADS, L::BYTES, stream, m[0], m[1], m[2],
                m[3], (float*)dq, (const float*)lse, (const float*)delta, (const float*)glse, BH,
                Sq, Sk, scale, causal, qo, ko);
}

// dK/dV's launch at head dim D.
template <int D>
int launch_dkv_x(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* glse, void* dk, void* dv, int BH, int Sq, int Sk,
                 float scale, int causal, int qo, int ko, cudaStream_t stream) {
  using L = BwdX<D>;
  CUtensorMap m[4];
  dim3 grid;
  const int err =
      x_setup(m, q, k, v, dout, BH, Sq, Sk, D, BH * ((Sk + L::ROWS - 1) / L::ROWS), &grid);
  if (err) return err;
  return launch(flash_dkv_3xtf32_kernel<D>, grid, SM90_THREADS, L::BYTES, stream, m[0], m[1],
                m[2], m[3], (float*)dk, (float*)dv, (const float*)lse, (const float*)delta,
                (const float*)glse, BH, Sq, Sk, scale, causal, qo, ko);
}

// The backward at head dim D: 32, 64, 128 and 256.
template <typename... Args>
int launch_dq_d(int D, Args... args) {
  switch (D) {
    case 32: return launch_dq_x<32>(args...);
    case 64: return launch_dq_x<64>(args...);
    case 128: return launch_dq_x<128>(args...);
    case 256: return launch_dq_x<256>(args...);
  }
  return cudaErrorInvalidValue;
}

template <typename... Args>
int launch_dkv_d(int D, Args... args) {
  switch (D) {
    case 32: return launch_dkv_x<32>(args...);
    case 64: return launch_dkv_x<64>(args...);
    case 128: return launch_dkv_x<128>(args...);
    case 256: return launch_dkv_x<256>(args...);
  }
  return cudaErrorInvalidValue;
}

// The fused backward's launch at head dim D: one work tile a head.
template <int D>
int launch_dqkv_x(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* glse, void* dq, void* dk,
                  void* dv, int BH, int Sq, int Sk, float scale, int causal, int qo, int ko,
                  cudaStream_t stream) {
  CUtensorMap m[4];
  dim3 grid;
  const int err = x_setup(m, q, k, v, dout, BH, Sq, Sk, D, BH, &grid);
  if (err) return err;
  return launch(flash_dqkv_3xtf32_kernel<D>, grid, SM90_THREADS, DqkvX<D>::BYTES, stream, m[0],
                m[1], m[2], m[3], (float*)dq, (float*)dk, (float*)dv, (const float*)lse,
                (const float*)delta, (const float*)glse, BH, Sq, Sk, scale, causal, qo, ko);
}

// The forward kernel at head dim D with key tiles of BK: the multi-tile
// one at SEQ_TILE, the single-tile one at F_ROWS (only that one is
// instantiated).
template <int D, int BK>
auto fwd_kernel() {
  if constexpr (BK == SEQ_TILE)
    return flash_fwd_3xtf32_kernel<D>;
  else
    return flash_fwd_single_3xtf32_kernel<D>;
}

// A forward's launch at head dim D: the three operands' tensor maps and a
// persistent grid of min(work tiles, SMs) blocks.
template <int D, int BK>
int launch_fwd_x(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
                 int Sk, float scale, int causal, int qo, int ko, cudaStream_t stream) {
  using L = FwdX<D, BK>;
  CUtensorMap mq, mk, mv;
  int err, sms = 0;
  if ((err = x_map(&mq, q, Sq, BH, D)) || (err = x_map(&mk, k, Sk, BH, D)) ||
      (err = x_map(&mv, v, Sk, BH, D)) || (err = sm_count(&sms)))
    return err;
  const int nwork = BH * ((Sq + F_ROWS - 1) / F_ROWS);
  return launch(fwd_kernel<D, BK>(), dim3(nwork < sms ? nwork : sms), SM90_THREADS, L::BYTES,
                stream, mq, mk, mv, (float*)o, (float*)lse, BH, Sq, Sk, scale, causal, qo, ko);
}

// The forward at head dim D: 32, 64, 128 and (multi-tile only) 256.
template <int BK, typename... Args>
int launch_fwd_d(int D, Args... args) {
  switch (D) {
    case 32: return launch_fwd_x<32, BK>(args...);
    case 64: return launch_fwd_x<64, BK>(args...);
    case 128: return launch_fwd_x<128, BK>(args...);
    case 256:
      if constexpr (BK == SEQ_TILE) return launch_fwd_x<256, BK>(args...);
  }
  return cudaErrorInvalidValue;
}


}  // namespace

// The launchers flash_attention.cu calls for every float32 dQ and dK/dV:
// head dims 32, 64, 128 and 256 (the wrapper zero-pads D = 16 to 32, and
// the others to the next), on the given stream, returning the cudaError_t
// of the launch (or HVD_ERR_TENSOR_MAP + the CUresult).
int launch_dq_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse, void* dq, int BH,
                     int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                     cudaStream_t stream) {
  return launch_dq_d(D, q, k, v, dout, lse, delta, glse, dq, BH, Sq, Sk, scale, causal, qo, ko,
                     stream);
}

int launch_dkv_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                      int BH, int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  return launch_dkv_d(D, q, k, v, dout, lse, delta, glse, dk, dv, BH, Sq, Sk, scale, causal, qo,
                      ko, stream);
}

// The launcher flash_attention_single.cu calls for every float32 fused
// backward: Sq and Sk at most 128 and not 0 (its caller checks), head dims
// 32, 64 and 128 (the wrapper zero-pads D = 16 to 32; any other D:
// cudaErrorInvalidValue).
int launch_dqkv_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* glse, void* dq, void* dk,
                       void* dv, int BH, int Sq, int Sk, int D, float scale, int causal, int qo,
                       int ko, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dqkv_x<32>(q, k, v, dout, lse, delta, glse, dq, dk, dv, BH, Sq, Sk, scale,
                               causal, qo, ko, stream);
    case 64:
      return launch_dqkv_x<64>(q, k, v, dout, lse, delta, glse, dq, dk, dv, BH, Sq, Sk, scale,
                               causal, qo, ko, stream);
    case 128:
      return launch_dqkv_x<128>(q, k, v, dout, lse, delta, glse, dq, dk, dv, BH, Sq, Sk, scale,
                                causal, qo, ko, stream);
  }
  return cudaErrorInvalidValue;
}

// The scratch the float32 wide-head dK/dV needs on the current device:
// each consumer warp's 16 x 64 fp32 operand of a chunk's Q tiles (at most
// WIDE_QCHUNK), for every block of its persistent grid of min(work tiles,
// SMs); -1 if the device cannot be queried.
long long wide_dkv_scratch_bytes(int BH, int Sq, int Sk) {
  int sms = 0;
  if (sm_count(&sms)) return -1;
  const long long work = (long long)BH * ((Sk + SEQ_TILE - 1) / SEQ_TILE);
  const int qtiles = (Sq + SEQ_TILE - 1) / SEQ_TILE;
  return (work < sms ? work : sms) * (qtiles < WIDE_QCHUNK ? qtiles : WIDE_QCHUNK) *
         CONSUMER_WARPS * X_XCH_BYTES;
}

// The launchers flash_attention_wide.cu calls for every float32 dQ and
// dK/dV at head dims above 256: D a multiple of X_BOX (the wrapper
// zero-pads; any other D: cudaErrorInvalidValue); a persistent grid over
// the work tiles of every pass.
int launch_dq_wide_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* glse, void* dq, int BH,
                          int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                          cudaStream_t stream) {
  if (D <= 256 || D % X_BOX) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk) return zero_fill(stream, (size_t)BH * Sq * D * sizeof(float), dq);
  const int passes = (D + 2 * WIDE_OUT - 1) / (2 * WIDE_OUT);
  CUtensorMap m[4];
  dim3 grid;
  const int err = x_setup(m, q, k, v, dout, BH, Sq, Sk, D,
                          BH * ((Sq + SEQ_TILE - 1) / SEQ_TILE) * passes, &grid);
  if (err) return err;
  return launch(flash_dq_wide_3xtf32_kernel, grid, SM90_THREADS, WideX::BYTES, stream, m[0], m[1],
                m[2], m[3], (float*)dq, (const float*)lse, (const float*)delta,
                (const float*)glse, BH, Sq, Sk, D, scale, causal, qo, ko);
}

int launch_dkv_wide_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* glse, void* dk,
                           void* dv, void* scratch, long long scratch_bytes, int BH, int Sq,
                           int Sk, int D, float scale, int causal, int qo, int ko,
                           cudaStream_t stream) {
  if (D <= 256 || D % X_BOX) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk) return zero_fill(stream, (size_t)BH * Sk * D * sizeof(float), dk, dv);
  CUtensorMap m[4];
  dim3 grid;
  const int err = x_setup(m, q, k, v, dout, BH, Sq, Sk, D, BH * ((Sk + SEQ_TILE - 1) / SEQ_TILE),
                          &grid);
  if (err) return err;
  if (scratch_bytes < wide_dkv_scratch_bytes(BH, Sq, Sk)) return cudaErrorInvalidValue;
  return launch(flash_dkv_wide_3xtf32_kernel, grid, SM90_THREADS, WideX::BYTES, stream, m[0],
                m[1], m[2], m[3], (float*)dk, (float*)dv, (float4*)scratch, (const float*)lse,
                (const float*)delta, (const float*)glse, BH, Sq, Sk, D, scale, causal, qo, ko);
}

// The launcher flash_attention_wide.cu calls for every float32 forward at
// head dims above 256: D a multiple of X_BOX (any other D:
// cudaErrorInvalidValue); a persistent grid over the work tiles of every
// pass.
int launch_fwd_wide_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                           cudaStream_t stream) {
  if (D <= 256 || D % X_BOX) return cudaErrorInvalidValue;
  if (!BH || !Sq || !Sk)
    return fwd_empty(o, (size_t)BH * Sq * D * sizeof(float), lse, (long long)BH * Sq, stream);
  const int passes = (D + 2 * WIDE_OUT - 1) / (2 * WIDE_OUT);
  const int nwork = BH * ((Sq + SEQ_TILE - 1) / SEQ_TILE) * passes;
  CUtensorMap mq, mk, mv;
  int err, sms = 0;
  if ((err = x_map(&mq, q, Sq, BH, D)) || (err = x_map(&mk, k, Sk, BH, D)) ||
      (err = x_map(&mv, v, Sk, BH, D)) || (err = sm_count(&sms)))
    return err;
  return launch(flash_fwd_wide_3xtf32_kernel, dim3(nwork < sms ? nwork : sms), SM90_THREADS,
                WideX::BYTES, stream, mq, mk, mv, (float*)o, (float*)lse, BH, Sq, Sk, D, scale,
                causal, qo, ko);
}

// The forwards (flash_attention.cu's launch_fwd and flash_attention_single.cu's
// launch_fwd_single call them for every float32 call): head dims 32, 64, 128
// and 256 (single-tile: up to 128); D = 16 is zero-padded to 32 by the
// wrapper (horovod_tpu_torch/ops/attention.py), since a box row is 32 fp32
// columns.
int launch_fwd_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                      int Sq, int Sk, int D, float scale, int causal, int qo, int ko,
                      cudaStream_t stream) {
  return launch_fwd_d<SEQ_TILE>(D, q, k, v, o, lse, BH, Sq, Sk, scale, causal, qo, ko, stream);
}

int launch_fwd_single_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse,
                             int BH, int Sq, int Sk, int D, float scale, int causal, int qo,
                             int ko, cudaStream_t stream) {
  return launch_fwd_d<F_ROWS>(D, q, k, v, o, lse, BH, Sq, Sk, scale, causal, qo, ko, stream);
}
