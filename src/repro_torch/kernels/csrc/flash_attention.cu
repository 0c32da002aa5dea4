// Flash attention for Hopper (sm_90a): forward (B5), dq (B6) and dk/dv (B7).
//
// B5 replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (:77, pallas_call at :250), B6 _flash_bwd_dq_kernel (:158,
// pallas_call at :288) and B7 _flash_bwd_dkv_kernel (:194, pallas_call at
// :319), in their f32, bf16 and int8 operand modes:
//     s   = mask(softcap(scale * q k^T))            mask: causal, window, k < T
//     o   = softmax(s) v,   lse = m + log(max(l, 1e-30))           (B5)
//     p   = mask ? exp(s - lse) : 0,   ds = p (do v^T - delta) (1 - t^2) scale
//     dq  = ds k                                                   (B6)
//     dv  = sum over the G heads of the group of p^T do,  dk = ds^T q   (B7)
// with delta = rowsum(do * o) computed between the kernels by the wrapper,
// t the pre-mask tanh of the softcap (so masked entries give exactly 0), the
// running (m, l, acc) of the online softmax in f32, the tile skip of
// _block_visible and the mask of _tile_mask (flash_attention.py:54-74).
//
// Operand modes (argument `mode`), each tile matmul being the reference's
// kernel_dot(a, b) (src/repro/quant/core.py:48), and the kernels that serve
// them:
//   0 = f32: every tile matmul in f32.  flash_fwd_kernel,
//       flash_bwd_dq_kernel, flash_bwd_dkv_kernel (FFMA).
//   1 = bf16: each operand of each tile matmul is rounded to bf16 (nearest
//       even) where kernel_dot rounds it -- q and k^T; the unnormalized p and
//       v; do and v^T; ds and k; p^T and do; ds^T and q -- and the products
//       are summed in f32.  A product of two bf16 values is exact in f32, so
//       the modes' kernels differ only in the order of the sums.
//       flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel and
//       flash_bwd_dkv_tc_kernel, on the tensor cores (mma.sync m16n8k16
//       bf16 -> f32).  This is the mode `train --amp bf16` runs.
//   2 = int8: a is quantized per row and b per column over the contraction
//       axis (scale = absmax / 127 by IEEE division, q = rint(x / max(scale,
//       1e-12)) half to even, clipped to +-127), the int8 products summed
//       exactly in int32, then (float)acc * sa * sb in that order
//       (quant/core.py:31-41, :63-67).  q k^T and do v^T take their scales
//       over d; p v and ds k over the tile's keys; p^T do and ds^T q over
//       the tile's queries.  B5: flash_quant_fwd_i8_kernel quantizes k
//       (per row over d) and v (per column over each 128-key tile) once a
//       call, then flash_fwd_i8_kernel quantizes q per row at each item's
//       set-up and multiplies on the s8 tensor cores.  B6 and B7:
//       flash_quant_i8_kernel quantizes q, k, v and do once a call along
//       every axis the two need, then flash_bwd_dq_i8_kernel and
//       flash_bwd_dkv_i8_kernel multiply on the s8 tensor cores.  All three
//       run mma.sync m16n8k32 (s8 -> s32); their notes are with the
//       pre-passes and the kernels.
// Storage: q, k, v, do in f32 or bf16 (all one type); o in q's type; lse,
// dq, dk, dv in f32.
//
// Tiles.  The reference's model tiles 128 x 128 (repro kernels/ops.py
// block_q = block_k = 128).  An axis whose width changes the numbers is 128
// wide here: B5's keys in every mode (p = exp(s - m) is rounded or
// quantized relative to the running max over the tiles seen), B6's keys
// (ds k) and B7's queries (p^T do, ds^T q) in the int8 mode.  The other
// axis stays 64: a row's (or a key's) numbers do not depend on it, and a
// pair the wider tile would visit but a narrow one skips holds p = ds = 0,
// which adds an exact 0.  kernels/ref.py FLASH_TILES names the same widths.
//
// What bounds them on the H100: at mup-gpt's training shape (8 x 512 x 16
// heads of 64, causal) the tile matmuls are 4, 6 and 8 d operations per
// visible (query, key) pair (4.3, 6.5 and 8.6 G) over 67-101 MB of reads and
// writes: bound by operations in f32 (67 TFLOP/s, 0.06-0.13 ms) and by bytes
// with bf16 or int8 tensor cores (3.35 TB/s against 989 TFLOP/s or 1,979
// TOP/s; 0.02-0.03 ms).  So a bf16 kernel that reaches the tensor cores has
// its time in moving and rounding tiles and in the softmax's exp, not in
// its products.
//
// Design of the FFMA kernels (mode 0):
//  - 256 threads as a 16 x 16 grid.  In a score tile of 64 rows by 64 or
//    128 columns (queries by keys; B7 keys by queries) each thread owns rows
//    ty + 16 i and columns tx + 16 j, and a 4 x d/16 block of the output
//    accumulator.  Head dims up to 256 are zero-padded to DP = 64, 128 or
//    256 in shared memory (zeros change no absmax; DP 256 below).
//  - Grids: B5 and B6 one block per (64-row q tile, head, batch), looping
//    over the visible k tiles; B7 one block per (64-key k tile, kv head,
//    batch), looping over the G query heads of the group and, inside, the
//    visible q tiles, as the TPU grid (B, K, nk, G, nq) does.  The TPU grid
//    carries the accumulators in VMEM across its sequential axes; here a
//    loop inside the block carries them in registers.
//  - Shared memory (f32 rows padded by one word so the column reads of a
//    warp fall in different banks): B5 q, k and v with the p tile over k's
//    space once s is formed, 83 KB at DP = 64 and 165 KB at DP = 128; B6 q,
//    do, k, v and the ds tile, 83 KB; B7 k, v, q, do, p^T and ds^T, 100 KB.
//    Each is above 48 KB, so each launch opts in to dynamic shared memory.
//  - Reductions: the row max and row sum of a score tile by warp shuffles;
//    every dot product in a fixed order.
// In the int8 mode (its kernels' notes are with them below) the f32 steps
// before a quantization round as the reference rounds them
// (__fmul_rn/__fadd_rn: no fused multiply-add).
//
// Design of the tensor-core kernels (mode 1; mma.cuh holds the PTX; B6's
// own note is above flash_bwd_dq_tc_kernel):
//  - Warps: each owns 16 rows of the score tile.  B5: 8 warps, 128 query
//    rows an item (the k/v tiles it stages and rounds serve twice the rows
//    of a 64-row tile), by the tile's 128 keys; one block an SM walks its
//    share of the (q tile, head, batch) items, q tiles in reverse (the
//    causal rows that see the most keys first), its tiles one stream, so the
//    copies of the next item's q and first k/v tile fly while an item ends.
//    B7: 4 warps, the block's 64 keys by each q tile's 64 queries, worked in
//    halves of kQW = 32 (s^T = k q^T and dp^T = v do^T, keys as the M rows).
//    The score tile lives in registers in the m16n8k16 accumulator layout,
//    which is the A layout of the next product: p (B5), p^T and ds^T (B7)
//    are rounded with cvt.rn.bf16x2.f32 straight into the A fragments of p
//    v, p^T do and ds^T q and never touch shared memory.  B5 keeps q as A
//    fragments for an item, rounded from its staged box; B7 reads its k and
//    v fragments from shared memory at each step (at DP = 128 the dk
//    and dv accumulators, 2 x 16 x 128 f32 a warp, leave no room for them).
//  - Shared memory: bf16 tiles with rows padded by 8 elements (16 bytes), so
//    the 8 rows one ldmatrix reads fall in 8 different 16-byte bank groups;
//    ldmatrix for the k, q and do operands of s and dp, ldmatrix.trans for
//    v, do and q as the B operand of p v, p^T do and ds^T q.  d < DP is
//    zero-padded in both operands of both products (an exact 0).  B5: k, v
//    and q staging tiles of 128 rows in the storage type and the bf16 k and
//    v tiles, 132 KB at DP = 64 (f32 storage); at DP = 128 in f32 q is read
//    from device memory (196 KB).  B7: staging for q and do with
//    lse and delta, bf16 k, v, q and do tiles: 69 KB (three blocks an SM) /
//    133 KB.
//  - Copies: the copy engine (TMA) moves each staged tile as one box of a
//    3-D tensor map (d, heads, batch x rows) built by the host, started by one
//    thread and completing on an mbarrier, while the block multiplies the
//    previous tile: in B5 k and v of the next tile of the stream (and q of
//    the next item), in B7 the next (q, do) with lse and delta (4-byte
//    cp.async: a q tile's rows of lse are not 16-byte aligned).  One
//    16-byte cp.async a thread, or one bulk copy a row, took as long to
//    start as the products took (measured); a box is one instruction.  f32
//    storage (the --amp bf16 path) must be rounded before ldmatrix can read
//    it, so the staging keeps the storage type and the whole block rounds
//    each tile once into the bf16 tiles (16 bytes a thread); prefetching f32
//    tiles into registers instead would need 64-128 more registers a thread
//    beside the accumulators.  Rows the copy engine
//    cannot move (d values of T not a multiple of 16 bytes, or a tensor not
//    16-byte aligned) are staged element by element by the block.
//  - Branches: the softcap and the mask are template flags of the
//    element-wise steps (fwd_logits, dkv_grads), chosen once a tile (a tile
//    with every pair visible is not masked), so the loops over a thread's
//    elements have no branches.
//  - Numbers: the logit is __fmul_rn(dot, scale) then the softcap's tanh;
//    p = expf(s - m) (B5) or expf(x - lse) (B7) -- no exp2f with log2(e)
//    folded into the scale, which would move p by ulps and, through the bf16
//    rounding, flip operands.  B5's l sums the unrounded p in the
//    fragments' order (n-tiles, then the pair, then lanes xor 1, 2; the
//    plain version's ref._mma_row_sum) and updates as __fadd_rn(
//    __fmul_rn(alpha, l), rowsum).  An MMA sums its 16 products in its own
//    order; the plain versions sum in theirs, so the two agree to f32
//    summation error before bf16 rounding, and to the bf16 tiers after it.
//  - dk and dv (every mode) are summed over the group's heads and q tiles in
//    a fixed order inside one block: no atomics, and a repeated call gives
//    the same bits.  Any S and T: the ragged last tile is masked (k < T, q <
//    S) and its rows load as zeros, so there is no S % 64 (or 128) rule.
//  - No fallback: mode 1 of B5-B7 always launches these kernels; a
//    launch the card refuses (shared memory, attributes, a tensor map) is an
//    error.
//  - What holds them back (an H100 at the train shape, PERF.md section 6;
//    scripts/torch_flash_probe.py): B5 runs at ~3.5x its bytes bound, B7 at
//    ~3.0x.  Per 128-key tile, B5's warps spend most of their cycles in the
//    softmax (expf on the MUFU pipe and its FMA work), then in the barriers
//    and the rounding of the staged f32 tiles, then in the two products;
//    all eight warps pass the same phases between the same barriers, so the
//    tensor cores idle while the softmax runs.  Each item's epilogue (o = acc
//    / l, two values a store) and q set-up cost most of a tile more.
// DP = 256 (d_head 129 to 256; gemma2's heads of 256).  Every kernel and
// pre-pass has a DP 256 instance; the layouts above would not fit (one f32
// k tile of 128 keys x 256 is 128 KB; o's accumulator alone, 16 x 256 f32
// a warp, 128 registers a thread).  What changes, nothing else does: the
// contraction over d (q k^T, do v^T) stays one accumulator walking d from 0
// to 255 (in steps of 16 on the tensor cores, ref._mma_dot's order; one
// fma chain in FFMA), the 128-key (and int8 128-wide) tiles and the scales
// over all 256 columns (the pre-passes) stay; only the output's d columns,
// which are independent, are split.
//  - The tensor-core and int8 kernels and B7's FFMA kernel split o, dq,
//    dk and dv by columns: the grid's lowest index is one of two column
//    halves (out_cols, col_halves), and each block forms the whole score
//    tile, its softmax or p/ds step (the same bits in both halves) and the
//    products for its 128 columns; B5's lse is stored by half 0.  The
//    score work is done twice: the price of accumulators the size of DP
//    128's.
//  - The bf16 kernels have no staging tiles: round_rows reads k, v, q, do
//    straight from device memory into the padded bf16 tiles (p.tma then
//    flags rows of whole 16-byte pieces), and q's (B5, B6) and do's (B6)
//    fragments come from those tiles by ldmatrix at each k-step (in
//    registers they would take 64 more a thread).  B5-int8 quantizes q in
//    two passes (absmax, then bytes) into shared memory (Q8) and reads its
//    fragments the same way.
//  - The FFMA kernels stage the d axis of their f32 tiles in pieces of 128
//    columns: B5 k's pieces in turn for s and v's for the acc columns they
//    feed, B6 k's and v's pieces for s and dp then k's again for dq, B7 q's
//    and do's pieces for s^T and dp^T, then the piece of its columns.
//  - Shared memory a block at DP 256 (227 KB at most): FFMA B5 193 KB, B6
//    209 KB, B7 226 KB; bf16 B5 166 KB, B6 132 KB, B7 133 KB; int8 B5 123
//    KB, B6 209 KB, B7 128 KB; the pre-passes 138 KB.  Registers (ptxas -v
//    on an H100 build, f32 / bf16 storage; no spills): FFMA 202, 163/160,
//    128; bf16 B5 239, B6 185/182, B7 238; int8 B5 254/252, B6 244, B7
//    251; pre-passes 58-64.  One block an SM in every DP 256 kernel.
// Left for later: wgmma with a warpgroup per 64 rows; ping-pong of two
// warpgroups (one's softmax under the other's products); warp
// specialisation with setmaxnreg (a producer warpgroup that stages and
// rounds); bf16 storage copied straight into swizzled bf16 tiles; TMA
// multicast of a k/v tile to the q tiles of a cluster; in the int8 mode,
// the backward reusing the forward pre-pass's k8 (it would keep 4 MB a
// layer alive through the step) and B5-int8's softmax and p quantization
// (two thirds of its tile, PERF.md section 6) split between warps.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

// What crosses translation units: each padded d_head DP's kernels are
// instantiated in one of their own (this file at DP 64, with the C entry
// points; flash_attention_dp128.cu and flash_attention_dp256.cu include it
// with REPRO_FLASH_DP set), so that nvcc builds the three at once; the
// entry points reach a DP's launches through its DpLaunches.
namespace repro_flash {

struct Params {
  int B, S, T, H, K, d;
  float scale;
  int causal, window;
  float softcap;
  int mode;   // operand mode: 0 = f32, 1 = bf16, 2 = int8
  int tma = 0;  // the tensor-core kernels: rows staged by the copy engine; the
                // int8 pre-passes: rows of whole 16-byte pieces; B5-int8: q rows
                // of whole 4-value pieces
};

enum class Which { kFwd, kDq, kDkv };

// One DP's launches, `dtype` the storage type (0 float32, 1 bfloat16):
// B5, B6 or B7 in the f32 or bf16 operand mode; the int8 mode's backward
// and forward pre-passes, B5, and B6 or B7 on the pre-passes' buffers
struct DpLaunches {
  cudaError_t (*flash)(Which, int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, void* out0,
                       void* out1, const Params&, cudaStream_t);
  cudaError_t (*quant_i8)(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, void* const* ops, const Params&, cudaStream_t);
  cudaError_t (*quant_fwd_i8)(int dtype, const void* k, const void* v, void* const* ops,
                              const Params&, cudaStream_t);
  cudaError_t (*fwd_i8)(int dtype, const void* q, void* const* ops, void* o, void* lse,
                        const Params&, cudaStream_t);
  cudaError_t (*bwd_i8)(Which, void* const* ops, const float* lse, const float* delta,
                        float* out0, float* out1, const Params&, cudaStream_t);
};
DpLaunches launches_dp64();    // flash_attention.cu
DpLaunches launches_dp128();   // flash_attention_dp128.cu
DpLaunches launches_dp256();   // flash_attention_dp256.cu

}  // namespace repro_flash

namespace {

using repro::from_f32;
using repro::to_f32;
using repro_flash::DpLaunches;
using repro_flash::Params;
using repro_flash::Which;

constexpr int kBQ = 64;          // query rows per tile (B5, B6; B7 f32/bf16)
constexpr int kBK = 64;          // keys per tile (B7; B6 f32/bf16)
constexpr int kFwdBK = 128;      // B5's keys per tile, every mode
constexpr int kI8 = 128;         // the int8 tile axis that carries scales:
                                 // B6's keys, B7's queries
constexpr int kThreads = 256;    // a 16 x 16 thread grid
constexpr float kNegInf = -2.3819763e38f;   // the reference's NEG_INF
constexpr int kMaxD = 256;       // the widest d_head: DP = 64, 128 or 256

// The output's d columns (o, dq, dk, dv) a block holds: all of DP up to
// 128.  At DP = 256 the tensor-core and int8 kernels and B7's FFMA kernel
// split them between two blocks of 128 each (the grid's column halves),
// each forming the whole score tile over d, so the contraction over d stays
// one accumulator walking d from 0 to DP - 1; the FFMA kernels stage the d
// axis of their f32 tiles in pieces of this width.
template <int DP> __host__ __device__ constexpr int out_cols() { return DP > 128 ? 128 : DP; }
template <int DP> __host__ __device__ constexpr int col_halves() { return DP / out_cols<DP>(); }

// _block_visible: could any (query, key) pair of the tile pair (nq query
// rows from q0, nk keys from k0) be visible?
__device__ __forceinline__ bool tile_visible(int q0, int nq, int k0, int nk,
                                             const Params& p) {
  bool needed = true;
  if (p.causal) needed = k0 <= q0 + nq - 1;
  if (p.window) needed = needed && (k0 + nk - 1 >= q0 - p.window + 1);
  return needed;
}

// _tile_mask for one pair
__device__ __forceinline__ bool visible(int qi, int ki, const Params& p) {
  bool m = ki < p.T;
  if (p.causal) m = m && ki <= qi;
  if (p.window) m = m && (qi - ki) < p.window;
  return m;
}

// the logit before the mask, and the tanh of the softcap (0 without one);
// each product rounded on its own, as the reference's `s * scale` and
// `softcap * tanh(s / softcap)`
__device__ __forceinline__ float logit(float dot, const Params& p, float& t) {
  float x = __fmul_rn(dot, p.scale);
  t = 0.f;
  if (p.softcap > 0.f) {
    t = tanhf(x / p.softcap);
    x = __fmul_rn(p.softcap, t);
  }
  return x;
}

// rows [row0, row0 + n) of one head (rows `stride` elements apart),
// columns [c0, c0 + W), into a (n, W) f32 tile with leading dimension ld;
// zeros beyond `valid` rows and beyond d columns
template <typename T, int W>
__device__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                          size_t stride, int row0, int n, int valid, int d, int c0 = 0) {
  for (int i = threadIdx.x; i < n * W; i += kThreads) {
    const int r = i / W;
    const int c = i - r * W;
    float x = 0.f;
    if (r < valid && c0 + c < d) x = to_f32(src[(size_t)(row0 + r) * stride + c0 + c]);
    dst[r * ld + c] = x;
  }
}

// warp reductions over the 16 threads (tx) of one row of the thread grid
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

// The FFMA kernels' shared memory (DC = out_cols<DP>(), the width of a
// staged piece of the d axis: all of DP up to 128).  B5: q [BQ][DP + 1], k
// [FwdBK][DC + 1] (the p tile [BQ][FwdBK + 1] takes its place once s is
// formed), v [FwdBK][DC].  B6: q, do [BQ][DP + 1], k, v [BK][DC + 1], ds
// [BQ][BK + 1].  B7: k, v [BK][DP + 1], q, do [BQ][DC + 1], p^T, ds^T [BK][BQ
// + 1], lse and delta.
template <int DP> constexpr size_t fwd_smem_words() {
  constexpr int DC = out_cols<DP>();
  static_assert(kBQ * (kFwdBK + 1) <= kFwdBK * (DC + 1), "p tile must fit in k's space");
  return (size_t)kBQ * (DP + 1) + (size_t)kFwdBK * (DC + 1) + (size_t)kFwdBK * DC;
}
template <int DP> constexpr size_t dq_smem_words() {
  return 2 * (size_t)kBQ * (DP + 1) + 2 * (size_t)kBK * (out_cols<DP>() + 1) +
         (size_t)kBQ * (kBK + 1);
}
template <int DP> constexpr size_t dkv_smem_words() {
  return 2 * (size_t)kBK * (DP + 1) + 2 * (size_t)kBQ * (out_cols<DP>() + 1) +
         2 * (size_t)kBK * (kBQ + 1) + 2 * kBQ;
}

// B5's epilogue: o = acc / max(l, 1e-30) in o's type, lse = m + log(max(l,
// 1e-30)), for the rows of this thread that lie below S
template <typename T, int NJ>
__device__ __forceinline__ void store_out(T* __restrict__ o, float* __restrict__ lse,
                                          const float (&acc)[4][NJ], const float (&m)[4],
                                          const float (&l)[4], int q0, int h, int b,
                                          int tx, int ty, const Params& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * p.S + row) * p.H + h) * p.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) orow[c] = from_f32<T>(acc[i][j] / lc);
    }
    if (tx == 0) lse[((size_t)b * p.H + h) * p.S + row] = m[i] + logf(lc);
  }
}

// B6's epilogue: this thread's rows of dq that lie below S
template <int NJ>
__device__ __forceinline__ void store_dq(float* __restrict__ dq, const float (&acc)[4][NJ],
                                         int q0, int h, int b, int tx, int ty,
                                         const Params& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    float* drow = dq + (((size_t)b * p.S + row) * p.H + h) * p.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) drow[c] = acc[i][j];
    }
  }
}

// B7's epilogue: this thread's rows of dk and dv among the tile's kvalid
// keys, the block's columns from c0
template <int NJ>
__device__ __forceinline__ void store_dkv(float* __restrict__ dk, float* __restrict__ dv,
                                          const float (&dk_acc)[4][NJ],
                                          const float (&dv_acc)[4][NJ], int k0, int kvalid,
                                          int kh, int b, int tx, int ty, int c0,
                                          const Params& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty + 16 * i;
    if (kr >= kvalid) continue;
    const size_t off = (((size_t)b * p.T + k0 + kr) * p.K + kh) * p.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < p.d) {
        dk[off + c] = dk_acc[i][j];
        dv[off + c] = dv_acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B5: forward, f32 operand mode (the bf16 mode is flash_fwd_tc_kernel)
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  // d in NPC pieces of DC columns (one piece up to DP = 128): k's pieces in
  // turn into ks for s, v's into vs for the acc columns they feed
  constexpr int DC = out_cols<DP>(), NPC = DP / DC;
  constexpr int LD = DP + 1, LDC = DC + 1, LDP = kFwdBK + 1, NJ = DP / 16, NJC = DC / 16,
                KJ = kFwdBK / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + kBQ * LD;        // [FwdBK][LDC]
  float* ps = ks;                   // [BQ][LDP] unnormalized p, once s is formed
  float* vs = ks + kFwdBK * LDC;    // [FwdBK][DC]

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const T* qb = q + ((size_t)b * p.S * p.H + h) * p.d;
  const T* kb = k + ((size_t)b * p.T * p.K + kh) * p.d;
  const T* vb = v + ((size_t)b * p.T * p.K + kh) * p.d;
  load_rows<T, DP>(qs, LD, qb, qstride, q0, kBQ, min(kBQ, p.S - q0), p.d);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.T + kFwdBK - 1) / kFwdBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kFwdBK;
    if (!tile_visible(q0, kBQ, k0, kFwdBK, p)) continue;   // uniform over the block
    __syncthreads();   // the previous tile's readers of ps (= ks) and vs are done
    const int kvalid = min(kFwdBK, p.T - k0);
    load_rows<T, DC>(ks, LDC, kb, kstride, k0, kFwdBK, kvalid, p.d);
    load_rows<T, DC>(vs, DC, vb, kstride, k0, kFwdBK, kvalid, p.d);
    __syncthreads();

    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int pc = 0; pc < NPC; ++pc) {   // d from 0 to DP - 1, one fma chain
      if (pc > 0) {
        __syncthreads();   // every reader of the last piece is done
        load_rows<T, DC>(ks, LDC, kb, kstride, k0, kFwdBK, kvalid, p.d, pc * DC);
        __syncthreads();
      }
#pragma unroll 4
      for (int c = 0; c < DC; ++c) {
        float a[4], kk[KJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + pc * DC + c];
#pragma unroll
        for (int j = 0; j < KJ; ++j) kk[j] = ks[(tx + 16 * j) * LDC + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }
    }
    __syncthreads();   // every reader of ks is done: ps takes its place

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float t;
        const float x = logit(s[i][j], p, t);
        s[i][j] = visible(row, k0 + tx + 16 * j, p) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pv = expf(s[i][j] - m_new);
        rs += pv;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = pv;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), row_sum(rs));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll
    for (int pc = 0; pc < NPC; ++pc) {   // acc's columns pc DC.. from v's piece pc
      if (pc > 0) {
        __syncthreads();   // every reader of the last piece is done
        load_rows<T, DC>(vs, DC, vb, kstride, k0, kFwdBK, kvalid, p.d, pc * DC);
        __syncthreads();
      }
#pragma unroll 8
      for (int kk = 0; kk < kFwdBK; ++kk) {
        float pr[4], vv[NJC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < NJC; ++j) vv[j] = vs[kk * DC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJC; ++j)
            acc[i][pc * NJC + j] = fmaf(pr[i], vv[j], acc[i][pc * NJC + j]);
      }
    }
  }

  store_out(o, lse, acc, m, l, q0, h, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// B6: dq, f32 operand mode (the bf16 mode is flash_bwd_dq_tc_kernel)
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Params p) {
  // d in NPC pieces of DC columns (one piece up to DP = 128): k's and v's
  // pieces in turn for s and dp, then k's again for the dq columns they feed
  constexpr int DC = out_cols<DP>(), NPC = DP / DC;
  constexpr int LD = DP + 1, LDC = DC + 1, LDP = kBK + 1, NJ = DP / 16, NJC = DC / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* dos = qs + kBQ * LD;       // [BQ][LD]
  float* ks = dos + kBQ * LD;       // [BK][LDC]
  float* vs = ks + kBK * LDC;       // [BK][LDC]
  float* dss = vs + kBK * LDC;      // [BQ][LDP]

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d;
  const T* kb = k + ((size_t)b * p.T * p.K + kh) * p.d;
  const T* vb = v + ((size_t)b * p.T * p.K + kh) * p.d;
  const int qvalid = min(kBQ, p.S - q0);
  load_rows<T, DP>(qs, LD, q + qoff, qstride, q0, kBQ, qvalid, p.d);
  load_rows<T, DP>(dos, LD, dout + qoff, qstride, q0, kBQ, qvalid, p.d);
  const float* lse_b = lse + ((size_t)b * p.H + h) * p.S;
  const float* delta_b = delta + ((size_t)b * p.H + h) * p.S;
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < p.S ? lse_b[row] : 0.f;
    delta_r[i] = row < p.S ? delta_b[row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.T + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_visible(q0, kBQ, k0, kBK, p)) continue;
    __syncthreads();
    const int kvalid = min(kBK, p.T - k0);

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int pc = 0; pc < NPC; ++pc) {   // d from 0 to DP - 1, one fma chain
      if (pc > 0) __syncthreads();       // every reader of the last piece is done
      load_rows<T, DC>(ks, LDC, kb, kstride, k0, kBK, kvalid, p.d, pc * DC);
      load_rows<T, DC>(vs, LDC, vb, kstride, k0, kBK, kvalid, p.d, pc * DC);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < DC; ++c) {
        float a[4], da[4], kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = qs[(ty + 16 * i) * LD + pc * DC + c];
          da[i] = dos[(ty + 16 * i) * LD + pc * DC + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kk[j] = ks[(tx + 16 * j) * LDC + c];
          vv[j] = vs[(tx + 16 * j) * LDC + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], kk[j], s[i][j]);
            dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        const float x = logit(s[i][j], p, t);
        const float pij = visible(row, k0 + tx + 16 * j, p) ? expf(x - lse_r[i]) : 0.f;
        float ds = pij * (dp[i][j] - delta_r[i]);
        if (p.softcap > 0.f) ds *= 1.f - t * t;
        dss[(ty + 16 * i) * LDP + tx + 16 * j] = ds * p.scale;
      }
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < NPC; ++n) {   // the piece in ks first, then k's others
      const int pc = NPC - 1 - n;
      if (n > 0) {
        __syncthreads();   // every reader of the last piece is done
        load_rows<T, DC>(ks, LDC, kb, kstride, k0, kBK, kvalid, p.d, pc * DC);
        __syncthreads();
      }
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float dsv[4], kv[NJC];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < NJC; ++j) kv[j] = ks[kk * LDC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJC; ++j)
            acc[i][pc * NJC + j] = fmaf(dsv[i], kv[j], acc[i][pc * NJC + j]);
      }
    }
  }

  store_dq(dq, acc, q0, h, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// B7: dk, dv, f32 operand mode (the bf16 mode is flash_bwd_dkv_tc_kernel)
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, Params p) {
  // d in NPC pieces of DC columns (one piece up to DP = 128): q's and do's
  // pieces in turn for s^T and dp^T; the block's columns of dk and dv are
  // one piece, c0.. (the grid's column halves at DP = 256)
  constexpr int DC = out_cols<DP>(), NPC = DP / DC;
  constexpr int LD = DP + 1, LDC = DC + 1, LQ = kBQ + 1, NJ = DC / 16;
  const int k0 = blockIdx.x / NPC * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % NPC, c0 = half * DC;
  const int G = p.H / p.K;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* ks = smem;                 // [BK][LD]
  float* vs = ks + kBK * LD;        // [BK][LD]
  float* qs = vs + kBK * LD;        // [BQ][LDC]
  float* dos = qs + kBQ * LDC;      // [BQ][LDC]
  float* pT = dos + kBQ * LDC;      // [BK][LQ] p^T
  float* dsT = pT + kBK * LQ;       // [BK][LQ] ds^T
  float* lse_s = dsT + kBK * LQ;    // [BQ]
  float* delta_s = lse_s + kBQ;     // [BQ]

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t koff = ((size_t)b * p.T * p.K + kh) * p.d;
  const int kvalid = min(kBK, p.T - k0);
  load_rows<T, DP>(ks, LD, k + koff, kstride, k0, kBK, kvalid, p.d);
  load_rows<T, DP>(vs, LD, v + koff, kstride, k0, kBK, kvalid, p.d);

  // this thread's rows of the k tile are ty + 16 i; its columns tx + 16 j
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (p.S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d;
    const float* lse_b = lse + ((size_t)b * p.H + h) * p.S;
    const float* delta_b = delta + ((size_t)b * p.H + h) * p.S;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      if (!tile_visible(q0, kBQ, k0, kBK, p)) continue;
      __syncthreads();   // the previous tile's readers are done
      const int qvalid = min(kBQ, p.S - q0);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        lse_s[r] = r < qvalid ? lse_b[q0 + r] : 0.f;
        delta_s[r] = r < qvalid ? delta_b[q0 + r] : 0.f;
      }

      // scores for query rows tx + 16 j and keys ty + 16 i
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int pc = 0; pc < NPC; ++pc) {   // d from 0 to DP - 1, one fma chain
        if (pc > 0) __syncthreads();       // every reader of the last piece is done
        load_rows<T, DC>(qs, LDC, q + qoff, qstride, q0, kBQ, qvalid, p.d, pc * DC);
        load_rows<T, DC>(dos, LDC, dout + qoff, qstride, q0, kBQ, qvalid, p.d, pc * DC);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < DC; ++c) {
          float kk[4], vv[4], a[4], da[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kk[i] = ks[(ty + 16 * i) * LD + pc * DC + c];
            vv[i] = vs[(ty + 16 * i) * LD + pc * DC + c];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j] = qs[(tx + 16 * j) * LDC + c];
            da[j] = dos[(tx + 16 * j) * LDC + c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(a[j], kk[i], s[i][j]);
              dp[i][j] = fmaf(da[j], vv[i], dp[i][j]);
            }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int row = q0 + r;
          float t;
          const float x = logit(s[i][j], p, t);
          const bool vis = row < p.S && visible(row, k0 + kr, p);
          const float pij = vis ? expf(x - lse_s[r]) : 0.f;
          float ds = pij * (dp[i][j] - delta_s[r]);
          if (p.softcap > 0.f) ds *= 1.f - t * t;
          pT[kr * LQ + r] = pij;
          dsT[kr * LQ + r] = ds * p.scale;
        }
      }
      __syncthreads();
      if (half != NPC - 1) {   // (uniform) the piece of this block's columns
        load_rows<T, DC>(qs, LDC, q + qoff, qstride, q0, kBQ, qvalid, p.d, c0);
        load_rows<T, DC>(dos, LDC, dout + qoff, qstride, q0, kBQ, qvalid, p.d, c0);
        __syncthreads();
      }

#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], dsv[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pT[(ty + 16 * i) * LQ + r];
          dsv[i] = dsT[(ty + 16 * i) * LQ + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = dos[r * LDC + tx + 16 * j];
          qv[j] = qs[r * LDC + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  store_dkv(dk, dv, dk_acc, dv_acc, k0, kvalid, kh, b, tx, ty, c0, p);
}

// ---------------------------------------------------------------------------
// int8 operand mode
// ---------------------------------------------------------------------------

// (float)acc * sa * sb, each step rounded on its own (kernel_dot's rescale)
__device__ __forceinline__ float rescale(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

// a bump allocator over dynamic shared memory, 16-byte aligned pieces; the
// host sizes the same pieces with smem_piece
__host__ __device__ constexpr size_t smem_piece(size_t bytes) { return (bytes + 15) / 16 * 16; }
struct Carve {
  unsigned char* at;
  template <typename U> __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(at);
    at += smem_piece(n * sizeof(U));
    return r;
  }
};

// ---------------------------------------------------------------------------
// B5-B7 in the bf16 operand mode: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // B6 and B7: 4 warps of 16 rows of the score tile

// bf16 row stride of a staged tile: 8 elements (16 bytes) of padding put
// the 8 rows that one ldmatrix reads in 8 different 16-byte bank groups
template <int DP> __host__ __device__ constexpr int tc_ld() { return DP + 8; }

// B5: 8 warps of 16 query rows, 128 rows a block
constexpr int kFwdTcBQ = 128;
constexpr int kFwdTcThreads = 2 * kFwdTcBQ;
// B5's shared memory: the staging tiles of k and v (128 rows of DP in the
// storage type), of q where it fits (not at DP = 128 in f32, where q is
// read from device memory), the bf16 k and v tiles and two mbarriers
template <typename T, int DP> __host__ __device__ constexpr bool fwd_tc_q_staged() {
  return sizeof(T) * kFwdTcBQ * DP <= 32768;
}
// (at DP = 256: no staging; the bf16 k and q tiles, DP wide, the bf16 v
// tile of the block's 128 columns and the mbarriers, 166 KB)
template <typename T, int DP> constexpr size_t fwd_tc_smem_bytes() {
  if constexpr (DP > 128)
    return 128 + 2 * smem_piece(2 * kFwdBK * tc_ld<DP>()) +
           smem_piece(2 * kFwdBK * tc_ld<out_cols<DP>()>()) + smem_piece(16);
  return 128 + (fwd_tc_q_staged<T, DP>() ? 3 : 2) * smem_piece(sizeof(T) * kFwdBK * DP)
       + 2 * smem_piece(2 * kFwdBK * tc_ld<DP>()) + smem_piece(16);
}
// B7: staging for q and do (64 rows each) with lse and delta; bf16 k, v, q
// and do tiles of 64 rows; lse and delta of the tile's queries; the
// staging's mbarrier
// (at DP = 256 no staging: 133 KB)
template <typename T, int DP> constexpr size_t dkv_tc_smem_bytes() {
  return 128 + (DP > 128 ? 0 : smem_piece(sizeof(T) * 2 * kBQ * DP) + smem_piece(4 * 2 * kBQ))
       + 4 * smem_piece(2 * kBQ * tc_ld<DP>()) + 2 * smem_piece(4 * kBQ) + smem_piece(8);
}

// the dynamic shared memory from its first 128-byte boundary (the copy
// engine writes boxes to 128-byte aligned addresses; the sizes above hold
// 128 bytes of slack)
__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (repro::smem_addr(p) & 127)) & 127);
}

// Rows [row0, row0 + valid) of one head (rows `stride` elements apart, d
// values each) into the staging tile F [.][DP], element by element by the
// NTHR threads (this one `tid`): the path for rows that the copy engine
// cannot move (d values of T not a multiple of 16 bytes, or a tensor not
// 16-byte aligned).  Nothing is written beyond d or beyond `valid`;
// to_bf16_tile zeroes those.
template <typename T, int DP, int NTHR>
__device__ __forceinline__ void load_rows_plain(T* F, const T* __restrict__ src, size_t stride,
                                                int row0, int valid, int d, int tid) {
  const T* base = src + (size_t)row0 * stride;
  for (int i = tid; i < valid * d; i += NTHR) {
    const int r = i / d, c = i - r * d;
    F[r * DP + c] = base[r * stride + c];
  }
}

// 8 staged values at F as f32
__device__ __forceinline__ void load8(const float* F, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(F);
  const float4 b = *reinterpret_cast<const float4*>(F + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* F, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(F);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// The staged rows F [N][ldf] (ldf = d from the copy engine, DP from
// load_rows_plain) rounded to bf16 (nearest even) into X [N][DP + 8], 16
// bytes a thread at a time; zeros at rows >= valid and columns >= d (a zero
// column of an operand adds an exact 0 to a product).
template <typename T, int DP, int N, int NTHR>
__device__ __forceinline__ void to_bf16_tile(bf16* X, const T* F, int ldf, int valid, int d,
                                             int tid) {
  constexpr int CPR = DP / 8;
  static_assert(N * CPR % NTHR == 0, "whole rounds of 16-byte stores");
#pragma unroll 2
  for (int it = 0; it < N * CPR / NTHR; ++it) {
    const int i = it * NTHR + tid, r = i / CPR, c = (i % CPR) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < d) {
      float x[8];
      load8(F + r * ldf + c, x);
      if (c + 8 > d)
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = c + e < d ? x[e] : 0.f;
      w = make_uint4(repro::pack_bf16(x[0], x[1]), repro::pack_bf16(x[2], x[3]),
                     repro::pack_bf16(x[4], x[5]), repro::pack_bf16(x[6], x[7]));
    }
    *reinterpret_cast<uint4*>(X + r * tc_ld<DP>() + c) = w;
  }
}

// Rows [row0, row0 + valid) of one head (rows `stride` elements apart),
// columns [c0, c0 + W), rounded to bf16 (nearest even) straight from device
// memory into X [N][W + 8], 16 bytes a thread at a time, zeros at rows >=
// valid and columns >= d: the DP = 256 kernels' staging, which has no room
// for a tile in the storage type.  `vec`: rows of whole 16-byte pieces, 16-byte
// aligned (tma_rows), read 8 values at once; else element by element.
template <typename T, int W, int N, int NTHR>
__device__ __forceinline__ void round_rows(bf16* X, const T* __restrict__ src, size_t stride,
                                           int row0, int valid, int d, int c0, bool vec,
                                           int tid) {
  constexpr int CPR = W / 8;
  static_assert(N * CPR % NTHR == 0, "whole rounds of 16-byte stores");
#pragma unroll 4
  for (int it = 0; it < N * CPR / NTHR; ++it) {
    const int i = it * NTHR + tid, r = i / CPR, c = (i % CPR) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c0 + c < d) {
      const T* x8 = src + (size_t)(row0 + r) * stride + c0 + c;
      float x[8];
      if (vec && c0 + c + 8 <= d) {
        load8(x8, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = c0 + c + e < d ? to_f32(x8[e]) : 0.f;
      }
      w = make_uint4(repro::pack_bf16(x[0], x[1]), repro::pack_bf16(x[2], x[3]),
                     repro::pack_bf16(x[4], x[5]), repro::pack_bf16(x[6], x[7]));
    }
    *reinterpret_cast<uint4*>(X + r * tc_ld<W>() + c) = w;
  }
}

// ldmatrix addresses, for lane `lane` of a warp, into a bf16 tile X with
// row stride LD:
//  a_frag: the A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16)
//  b_pair: the B fragments of the n-tiles [n0, n0 + 8) and [n0 + 8, n0 + 16)
//          at k [k0, k0 + 16), X holding n as rows (k contiguous)
//  bt_pair: the same with X holding k as rows (n contiguous), for .trans
template <int LD>
__device__ __forceinline__ const bf16* a_frag(const bf16* X, int r0, int c0, int lane) {
  return X + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* b_pair(const bf16* X, int n0, int k0, int lane) {
  return X + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* bt_pair(const bf16* X, int k0, int n0, int lane) {
  return X + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + n0 + (lane >> 4) * 8;
}

// (x0, x1) into the adjacent elements at dst (8-byte aligned for f32,
// 4-byte for bf16) in one store, each rounded as from_f32 rounds it
__device__ __forceinline__ void store_pair(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(bf16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

// the visible tiles of one axis: [first, last + 1) of the n tiles for which
// vis(tile) holds, or an empty range.  The causal and window rules each
// bound the tile index from one side, so the visible tiles are contiguous.
template <typename Vis>
__device__ __forceinline__ int2 visible_range(int n, Vis vis) {
  int lo = n, hi = 0;
  for (int t = 0; t < n; ++t)
    if (vis(t)) {
      lo = min(lo, t);
      hi = t + 1;
    }
  return make_int2(lo, max(lo, hi));
}

// The element-wise steps of the tensor-core kernels, with the softcap and
// the mask as template flags: the callers branch once a tile (uniformly)
// and the loops over a thread's score elements stay free of branches.  The
// numbers are logit()'s and visible()'s.
template <bool kCap>
__device__ __forceinline__ float tc_logit(float dot, const Params& p, float& t) {
  const float x = __fmul_rn(dot, p.scale);
  if (!kCap) return x;
  t = tanhf(x / p.softcap);
  return __fmul_rn(p.softcap, t);
}

// B5: the masked logits of a thread's score elements (rows row0 and row0 +
// 8; keys key0 + 8 j + 2 tq + e)
template <bool kCap, bool kMask, int NT>
__device__ __forceinline__ void fwd_logits(float (&s)[NT][4], int row0, int key0, int tq,
                                           const Params& p) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float t;
      const float x = tc_logit<kCap>(s[j][e], p, t);
      s[j][e] = !kMask || visible(row0 + 8 * (e >> 1), key0 + 8 * j + 2 * tq + (e & 1), p)
                    ? x : kNegInf;
    }
}

// B7: p^T = exp(s^T - lse) on the visible pairs and ds^T = p^T (dp^T -
// delta) (1 - t^2) scale of a thread's elements (keys key0 and key0 + 8;
// queries q0 + qi, qi = qh + 8 j + 2 tq + e), in place of s^T and dp^T
template <bool kCap, bool kMask, int QT>
__device__ __forceinline__ void dkv_grads(float (&st)[QT][4], float (&dpt)[QT][4],
                                          const float* ls, const float* dl, int key0, int q0,
                                          int qh, int tq, const Params& p) {
#pragma unroll
  for (int j = 0; j < QT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * (e >> 1), qi = qh + 8 * j + 2 * tq + (e & 1), row = q0 + qi;
      float t = 0.f;
      const float x = tc_logit<kCap>(st[j][e], p, t);
      const bool vis = !kMask || (row < p.S && visible(row, key, p));
      const float pij = vis ? expf(x - ls[qi]) : 0.f;
      float ds = pij * (dpt[j][e] - dl[qi]);
      if (kCap) ds *= 1.f - t * t;
      st[j][e] = pij;
      dpt[j][e] = ds * p.scale;
    }
}

// B6: ds = p (dp - delta) (1 - t^2) scale of a thread's elements (rows row0
// and row0 + 8, their lse lr and delta dr; keys key0 + 8 j + 2 tq + e), p
// = exp(x - lse) on the visible pairs and 0 elsewhere, in place of s
template <bool kCap, bool kMask, int NT>
__device__ __forceinline__ void dq_grads(float (&s)[NT][4], const float (&dp)[NT][4],
                                         const float (&lr)[2], const float (&dr)[2], int row0,
                                         int key0, int tq, const Params& p) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float t = 0.f;
      const float x = tc_logit<kCap>(s[j][e], p, t);
      const bool vis = !kMask || visible(row0 + 8 * r, key0 + 8 * j + 2 * tq + (e & 1), p);
      const float pij = vis ? expf(x - lr[r]) : 0.f;
      float ds = pij * (dp[j][e] - dr[r]);
      if (kCap) ds *= 1.f - t * t;
      s[j][e] = ds * p.scale;
    }
}

// B5's work items, (q tile, head, batch) and, at DP = 256, the half of
// the output's columns (nh halves of 128, the fastest index, so the halves
// of an item run side by side), in the order the blocks take them: the q
// tiles in reverse (under the causal mask the last rows see the most keys,
// so the longest items start first); block c takes items c, c + gridDim.x,
// ...
struct FwdItem {
  int q0, h, b, kh, c0;
  int2 kr;   // the visible key tiles
};
__device__ __forceinline__ FwdItem fwd_item(int i, int nh, const Params& p) {
  const int nq = (p.S + kFwdTcBQ - 1) / kFwdTcBQ, hb = p.H * p.B;
  FwdItem f;
  f.c0 = i % nh * 128;
  i /= nh;
  f.q0 = (nq - 1 - i / hb) * kFwdTcBQ;
  f.h = i % hb % p.H;
  f.b = i % hb / p.H;
  f.kh = f.h / (p.H / p.K);
  const int q0 = f.q0;
  f.kr = visible_range((p.T + kFwdBK - 1) / kFwdBK, [&](int t) {
    return tile_visible(q0, kFwdTcBQ, t * kFwdBK, kFwdBK, p);
  });
  return f;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kFwdTcThreads)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, Params p,
                    const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv) {
  // kWide (DP = 256): the block's output columns are one half, DC = 128,
  // of an item's (o's accumulator 16 x DP f32 a warp would take 128
  // registers); no staging tiles (one f32 k tile would take 128 KB): k and v
  // are rounded straight from device memory into Kb and Vb (v's DC columns
  // only), and q into Qb, from which the warps read its fragments for each
  // k-step; p.tma then flags rows of whole 16-byte pieces (round_rows).
  constexpr bool kWide = DP > 128;
  constexpr int DC = out_cols<DP>(), NH = DP / DC, LDV = tc_ld<DC>();
  constexpr int LD = tc_ld<DP>(), NT = kFwdBK / 8, DT = DC / 8, KS = DP / 16;
  constexpr int BQ = kFwdTcBQ, NTHR = kFwdTcThreads;
  const int items = (p.S + BQ - 1) / BQ * p.H * p.B * NH, G = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  Carve cv{align128(smem_tc)};
  // staging of k and v (128-byte aligned), and of q where it fits
  T* Fk = kWide ? nullptr : cv.take<T>(kFwdBK * DP);
  T* Fv = kWide ? nullptr : cv.take<T>(kFwdBK * DP);
  T* Fq = !kWide && fwd_tc_q_staged<T, DP>() ? cv.take<T>(BQ * DP) : nullptr;
  bf16* Kb = cv.take<bf16>(kFwdBK * LD);
  bf16* Vb = cv.take<bf16>(kFwdBK * LDV);
  bf16* Qb = kWide ? cv.take<bf16>(BQ * LD) : nullptr;
  uint64_t* staged = cv.take<uint64_t>(2);   // k and v; q
  if (threadIdx.x == 0) {
    repro::mbar_init(&staged[0], 1);
    repro::mbar_init(&staged[1], 1);
  }
  __syncthreads();
  const bool q_tma = !kWide && p.tma && Fq != nullptr;
  const int ldf = p.tma ? p.d : DP;     // the staging's row pitch

  // The block's tiles form one stream, the visible key tiles of its items
  // in turn: the copy of the next tile flies while one is multiplied, also
  // across items, and q of the next item while an item runs.  k and v of a
  // tile: one box each (128 rows of one head) for the copy engine, started
  // by one thread (rows past T in the box are the next batch's, or zeros
  // past the tensor, and are zeroed when rounded), or element by element
  // by the whole block; then rounded to bf16 into Kb and Vb by the block.
  auto first_tile = [&](int i, int& kt) {   // from item i on: (item, kt), or items
    for (; i < items; i += G) {
      const FwdItem f = fwd_item(i, NH, p);
      if (f.kr.x < f.kr.y) {
        kt = f.kr.x;
        return i;
      }
    }
    return items;
  };
  auto next_tile = [&](int i, int kt, int& nkt) {
    if (kt + 1 < fwd_item(i, NH, p).kr.y) {
      nkt = kt + 1;
      return i;
    }
    return first_tile(i + G, nkt);
  };
  auto stage_kv = [&](int i, int kt) {
    if constexpr (kWide) return;   // round_kv reads device memory itself
    const FwdItem f = fwd_item(i, NH, p);
    const int k0 = kt * kFwdBK;
    if (!p.tma) {
      const size_t kstride = (size_t)p.K * p.d, off = ((size_t)f.b * p.T * p.K + f.kh) * p.d;
      const int kvalid = min(kFwdBK, p.T - k0);
      load_rows_plain<T, DP, NTHR>(Fk, k + off, kstride, k0, kvalid, p.d, threadIdx.x);
      load_rows_plain<T, DP, NTHR>(Fv, v + off, kstride, k0, kvalid, p.d, threadIdx.x);
    } else if (threadIdx.x == 0) {
      repro::mbar_arrive_expect(&staged[0], 2 * kFwdBK * p.d * sizeof(T));
      repro::tma_load_3d(Fk, &tmk, 0, f.kh, f.b * p.T + k0, &staged[0]);
      repro::tma_load_3d(Fv, &tmv, 0, f.kh, f.b * p.T + k0, &staged[0]);
    }
  };
  uint32_t kv_phase = 0, q_phase = 0;
  auto round_kv = [&](int i, int kt) {   // after a barrier that follows the tile's stage_kv
    const int kvalid = min(kFwdBK, p.T - kt * kFwdBK);
    if constexpr (kWide) {
      const FwdItem f = fwd_item(i, NH, p);
      const size_t kstride = (size_t)p.K * p.d, off = ((size_t)f.b * p.T * p.K + f.kh) * p.d;
      round_rows<T, DP, kFwdBK, NTHR>(Kb, k + off, kstride, kt * kFwdBK, kvalid, p.d, 0, p.tma,
                                       threadIdx.x);
      round_rows<T, DC, kFwdBK, NTHR>(Vb, v + off, kstride, kt * kFwdBK, kvalid, p.d, f.c0,
                                       p.tma, threadIdx.x);
      return;
    }
    if (p.tma) {
      repro::mbar_wait(&staged[0], kv_phase);
      kv_phase ^= 1;
    }
    to_bf16_tile<T, DP, kFwdBK, NTHR>(Kb, Fk, ldf, kvalid, p.d, threadIdx.x);
    to_bf16_tile<T, DP, kFwdBK, NTHR>(Vb, Fv, ldf, kvalid, p.d, threadIdx.x);
  };
  auto stage_q = [&](int i) {
    if (q_tma && threadIdx.x == 0 && i < items) {
      const FwdItem f = fwd_item(i, NH, p);
      repro::mbar_arrive_expect(&staged[1], BQ * p.d * sizeof(T));
      repro::tma_load_3d(Fq, &tmq, 0, f.h, f.b * p.S + f.q0, &staged[1]);
    }
  };

  // (ri, rkt): the tile in Kb and Vb; (ni, nkt): the tile in flight
  int rkt = 0, nkt = 0;
  const int ri = first_tile(blockIdx.x, rkt);
  if (ri < items) stage_kv(ri, rkt);
  stage_q(blockIdx.x);
  int ni = items;
  if (ri < items) {
    __syncthreads();
    round_kv(ri, rkt);
    __syncthreads();   // Kb and Vb ready, staging free
    ni = next_tile(ri, rkt, nkt);
    if (ni < items) stage_kv(ni, nkt);
  }

  for (int i = blockIdx.x; i < items; i += G) {
    const FwdItem f = fwd_item(i, NH, p);
    const int q0 = f.q0;
    // this warp's 16 q rows as A fragments for the item, rounded to bf16
    // (zeros beyond S and d): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t +
    // 8..), a3 (g + 8, 2t + 8..) of each k-step; from the staged box, or
    // straight from device memory; at DP = 256 the block rounds the item's
    // q rows into Qb and the warps read the fragments at each k-step
    uint32_t qa[kWide ? 1 : KS][4];
    const size_t qstride = (size_t)p.H * p.d;
    const T* qb = q + ((size_t)f.b * p.S * p.H + f.h) * p.d;
    if constexpr (kWide) {
      __syncthreads();   // every warp is done with the last item's Qb
      round_rows<T, DP, BQ, NTHR>(Qb, qb, qstride, q0, min(BQ, p.S - q0), p.d, 0, p.tma,
                                  threadIdx.x);
      __syncthreads();
    } else {
      if (q_tma) {
        repro::mbar_wait(&staged[1], q_phase);
        q_phase ^= 1;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * warp + g + 8 * (e & 1), c = 16 * ks + 8 * (e >> 1) + 2 * tq;
          const bool in = q0 + r < p.S;
          const T* qr = q_tma ? Fq + r * p.d : qb + (size_t)(q0 + r) * qstride;
          qa[ks][e] = repro::pack_bf16(in && c < p.d ? to_f32(qr[c]) : 0.f,
                                       in && c + 1 < p.d ? to_f32(qr[c + 1]) : 0.f);
        }
      __syncthreads();   // every thread has read Fq
      stage_q(i + G);
    }

    // this thread's rows are q0 + 16 warp + g + 8 r (r = 0, 1); its columns
    // of each 8-wide n-tile j are 8 j + 2 tq + e (e = 0, 1)
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int kt = f.kr.x; kt < f.kr.y; ++kt) {   // Kb and Vb hold (i, kt)
      const int k0 = kt * kFwdBK;

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      auto qk = [&](int ks, const uint32_t (&qf)[4]) {   // s += q k^T at k-step ks
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kf[4];
          repro::ldmatrix_x4(kf, b_pair<LD>(Kb, 8 * j, 16 * ks, lane));
          repro::mma_bf16(s[j], qf, kf[0], kf[1]);
          repro::mma_bf16(s[j + 1], qf, kf[2], kf[3]);
        }
      };
#pragma unroll (DP > 128 ? 4 : DP / 16)
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (kWide) {
          uint32_t qf[4];
          repro::ldmatrix_x4(qf, a_frag<LD>(Qb, 16 * warp, 16 * ks, lane));
          qk(ks, qf);
        } else {
          qk(ks, qa[ks]);
        }
      }

      // the online softmax of each row over its four lanes; p = exp(s - m)
      // unrounded into l (summed over n-tiles j, then e, then lanes xor 1, 2:
      // ref._mma_row_sum), rounded to bf16 into the A fragments of p v
      const bool whole = k0 + kFwdBK <= p.T && (!p.causal || k0 + kFwdBK - 1 <= q0) &&
                         (!p.window || q0 + BQ - 1 - k0 < p.window);
      const int row0 = q0 + 16 * warp + g;
      if (p.softcap > 0.f) {
        if (whole) fwd_logits<true, false>(s, row0, k0, tq, p);
        else fwd_logits<true, true>(s, row0, k0, tq, p);
      } else {
        if (whole) fwd_logits<false, false>(s, row0, k0, tq, p);
        else fwd_logits<false, true>(s, row0, k0, tq, p);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[j][2 * r + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[j][2 * r + e] = expf(s[j][2 * r + e] - m_new);
            rs += s[j][2 * r + e];
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        const float alpha = expf(m[r] - m_new);
        l[r] = __fadd_rn(__fmul_rn(alpha, l[r]), rs);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }

      // acc += p v, keys 16 kk.. of p's accumulator layout packed as A
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t pa[4] = {repro::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                repro::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                repro::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                repro::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t vf[4];
          repro::ldmatrix_x4_trans(vf, bt_pair<LDV>(Vb, 16 * kk, 8 * j, lane));
          repro::mma_bf16(acc[j], pa, vf[0], vf[1]);
          repro::mma_bf16(acc[j + 1], pa, vf[2], vf[3]);
        }
      }
      if (ni < items) {   // the stream goes on: round the tile in flight, stage the next
        __syncthreads();   // every warp is done with Kb and Vb
        round_kv(ni, nkt);
        __syncthreads();   // Kb and Vb ready, staging free
        const int ci = ni, ckt = nkt;
        ni = next_tile(ci, ckt, nkt);
        if (ni < items) stage_kv(ni, nkt);
      }
    }

    // o = acc / max(l, 1e-30) in o's type, lse = m + log(max(l, 1e-30))
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row >= p.S) continue;
      const float lc = fmaxf(l[r], 1e-30f);
      T* orow = o + (((size_t)f.b * p.S + row) * p.H + f.h) * p.d;
#pragma unroll
      for (int j = 0; j < DT; ++j) {   // a thread's two adjacent columns in one store
        const int c = f.c0 + 8 * j + 2 * tq;
        const float x0 = acc[j][2 * r] / lc, x1 = acc[j][2 * r + 1] / lc;
        if (c + 1 < p.d && p.d % 2 == 0) {
          store_pair(orow + c, x0, x1);
        } else {
          if (c < p.d) orow[c] = from_f32<T>(x0);
          if (c + 1 < p.d) orow[c + 1] = from_f32<T>(x1);
        }
      }
      if (tq == 0 && f.c0 == 0) lse[((size_t)f.b * p.H + f.h) * p.S + row] = m[r] + logf(lc);
    }
  }
}

// B7 works each 64-query tile in halves of kQW queries: the score tiles
// s^T and dp^T of a half (2 x 16 x 32 f32 a warp) sit in registers beside
// the dk and dv accumulators (2 x 16 x DP), which at DP = 128 leaves no
// room for a whole tile's.  The halves add to dk and dv in the same order
// as whole tiles.  Three blocks an SM at DP = 64 (69 KB, at most 168
// registers), one at DP = 128.
constexpr int kQW = 32;

template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 3 : 1)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, Params p,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmdo) {
  // kWide (DP = 256): the block's dk and dv columns are one half, DC = 128,
  // c0.. (blockIdx.x's lowest index; dk and dv of 16 x DP f32 a warp would
  // take 256 registers); no staging: k and v are rounded straight from
  // device memory into Kb and Vb, q and do into Qb and Db at each tile,
  // and lse and delta read into ls and dl; p.tma then flags rows of whole
  // 16-byte pieces (round_rows)
  constexpr bool kWide = DP > 128;
  constexpr int DC = out_cols<DP>(), NH = DP / DC;
  constexpr int LD = tc_ld<DP>(), QT = kQW / 8, DT = DC / 8, KS = DP / 16, QS = kQW / 16;
  static_assert(kTcThreads == 2 * kBQ, "one thread a row of lse or delta");
  const int k0 = (int)blockIdx.x / NH * kBK, c0 = (int)blockIdx.x % NH * DC;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  Carve cv{align128(smem_tc)};
  // staging: k and v, then q and do (128-byte aligned); lse and delta of the
  // tile's queries
  T* F = kWide ? nullptr : cv.take<T>(2 * kBQ * DP);
  float* Fr = kWide ? nullptr : cv.take<float>(2 * kBQ);
  bf16* Kb = cv.take<bf16>(kBK * LD);
  bf16* Vb = cv.take<bf16>(kBK * LD);
  bf16* Qb = cv.take<bf16>(kBQ * LD);
  bf16* Db = cv.take<bf16>(kBQ * LD);
  float* ls = cv.take<float>(kBQ);
  float* dl = cv.take<float>(kBQ);
  uint64_t* bar = cv.take<uint64_t>(1);

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t koff = ((size_t)b * p.T * p.K + kh) * p.d;
  const int kvalid = min(kBK, p.T - k0);
  const int ldf = p.tma ? p.d : DP;     // the staging's row pitch
  // k and v: one box each (64 rows of one head) for the copy engine (the
  // barrier's phase 0; the q tile `it` below is its phase it + 1), or
  // element by element by the block
  if constexpr (kWide) {
    round_rows<T, DP, kBK, kTcThreads>(Kb, k + koff, kstride, k0, kvalid, p.d, 0, p.tma,
                                       threadIdx.x);
    round_rows<T, DP, kBK, kTcThreads>(Vb, v + koff, kstride, k0, kvalid, p.d, 0, p.tma,
                                       threadIdx.x);
  } else {
    if (threadIdx.x == 0) {
      repro::mbar_init(bar, 1);
      if (p.tma) {
        repro::mbar_arrive_expect(bar, 2 * kBK * p.d * sizeof(T));
        repro::tma_load_3d(F, &tmk, 0, kh, b * p.T + k0, bar);
        repro::tma_load_3d(F + kBK * DP, &tmv, 0, kh, b * p.T + k0, bar);
      }
    }
    if (!p.tma) {
      load_rows_plain<T, DP, kTcThreads>(F, k + koff, kstride, k0, kvalid, p.d, threadIdx.x);
      load_rows_plain<T, DP, kTcThreads>(F + kBK * DP, v + koff, kstride, k0, kvalid, p.d,
                                         threadIdx.x);
    }
    __syncthreads();   // the barrier initialised, the element-wise rows in
    if (p.tma) repro::mbar_wait(bar, 0);
    to_bf16_tile<T, DP, kBK, kTcThreads>(Kb, F, ldf, kvalid, p.d, threadIdx.x);
    to_bf16_tile<T, DP, kBK, kTcThreads>(Vb, F + kBK * DP, ldf, kvalid, p.d, threadIdx.x);
  }
  __syncthreads();

  // the work: the G query heads of the group in turn and, inside, the
  // visible q tiles in order; one staging tile, the next (q, do, lse,
  // delta) in flight while the current one is multiplied
  const int2 qr = visible_range((p.S + kBQ - 1) / kBQ, [&](int t) {
    return tile_visible(t * kBQ, kBQ, k0, kBK, p);
  });
  const int nqt = qr.y - qr.x, n = G * nqt;
  auto stage = [&](int it) {
    if constexpr (kWide) return;   // the loop reads device memory itself
    const int h = kh * G + it / nqt, q0 = (qr.x + it % nqt) * kBQ;
    const int qvalid = min(kBQ, p.S - q0);
    if (p.tma) {
      if (threadIdx.x == 0) {
        repro::mbar_arrive_expect(bar, 2 * kBQ * p.d * sizeof(T));
        repro::tma_load_3d(F, &tmq, 0, h, b * p.S + q0, bar);
        repro::tma_load_3d(F + kBQ * DP, &tmdo, 0, h, b * p.S + q0, bar);
      }
    } else {
      const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d;
      load_rows_plain<T, DP, kTcThreads>(F, q + qoff, qstride, q0, qvalid, p.d, threadIdx.x);
      load_rows_plain<T, DP, kTcThreads>(F + kBQ * DP, dout + qoff, qstride, q0, qvalid, p.d,
                                         threadIdx.x);
    }
    const int r = threadIdx.x % kBQ;   // lse by the first kBQ threads, delta by the rest
    if (r < qvalid)
      repro::cp_async4(Fr + threadIdx.x,
                       (threadIdx.x < kBQ ? lse : delta) + ((size_t)b * p.H + h) * p.S + q0 + r);
  };

  // this thread's keys are k0 + 16 warp + g + 8 r (r = 0, 1); its queries
  // of each 8-wide n-tile j are q0 + 8 j + 2 tq + e (e = 0, 1)
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (n > 0) stage(0);
  for (int it = 0; it < n; ++it) {
    const int q0 = (qr.x + it % nqt) * kBQ, qvalid = min(kBQ, p.S - q0);
    if constexpr (kWide) {
      __syncthreads();   // every warp is done with the last tile's Qb, Db
      const int h = kh * G + it / nqt;
      const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d, ro = ((size_t)b * p.H + h) * p.S;
      round_rows<T, DP, kBQ, kTcThreads>(Qb, q + qoff, qstride, q0, qvalid, p.d, 0, p.tma,
                                         threadIdx.x);
      round_rows<T, DP, kBQ, kTcThreads>(Db, dout + qoff, qstride, q0, qvalid, p.d, 0, p.tma,
                                         threadIdx.x);
      for (int r = threadIdx.x; r < kBQ; r += kTcThreads) {
        ls[r] = r < qvalid ? lse[ro + q0 + r] : 0.f;
        dl[r] = r < qvalid ? delta[ro + q0 + r] : 0.f;
      }
    } else {
      if (p.tma) repro::mbar_wait(bar, (it + 1) & 1);
      repro::cp_async_wait_all();
      __syncthreads();   // staged; every warp is done with the last tile's Qb, Db
      to_bf16_tile<T, DP, kBQ, kTcThreads>(Qb, F, ldf, qvalid, p.d, threadIdx.x);
      to_bf16_tile<T, DP, kBQ, kTcThreads>(Db, F + kBQ * DP, ldf, qvalid, p.d, threadIdx.x);
      for (int r = threadIdx.x; r < kBQ; r += kTcThreads) {
        ls[r] = r < qvalid ? Fr[r] : 0.f;
        dl[r] = r < qvalid ? Fr[kBQ + r] : 0.f;
      }
    }
    __syncthreads();   // tiles ready, staging free
    if (it + 1 < n) stage(it + 1);
    // every pair of the tile visible: the queries lie below S and past (or,
    // under a window, within it of) every key, and the keys below T
    const bool whole = q0 + kBQ <= p.S && k0 + kBK <= p.T &&
                       (!p.causal || k0 + kBK - 1 <= q0) &&
                       (!p.window || q0 + kBQ - 1 - k0 < p.window);

#pragma unroll 1
    for (int qh = 0; qh < kBQ; qh += kQW) {
      // s^T = k q^T and dp^T = v do^T: this warp's 16 keys by the half's queries
      float st[QT][4], dpt[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll (DP > 128 ? 4 : DP / 16)
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4], vf[4];
        repro::ldmatrix_x4(kf, a_frag<LD>(Kb, 16 * warp, 16 * ks, lane));
        repro::ldmatrix_x4(vf, a_frag<LD>(Vb, 16 * warp, 16 * ks, lane));
#pragma unroll
        for (int j = 0; j < QT; j += 2) {
          uint32_t qf[4], df[4];
          repro::ldmatrix_x4(qf, b_pair<LD>(Qb, qh + 8 * j, 16 * ks, lane));
          repro::ldmatrix_x4(df, b_pair<LD>(Db, qh + 8 * j, 16 * ks, lane));
          repro::mma_bf16(st[j], kf, qf[0], qf[1]);
          repro::mma_bf16(st[j + 1], kf, qf[2], qf[3]);
          repro::mma_bf16(dpt[j], vf, df[0], df[1]);
          repro::mma_bf16(dpt[j + 1], vf, df[2], df[3]);
        }
      }
      // p^T and ds^T in place (dkv_grads), a tile with every pair visible
      // unmasked
      const int key0 = k0 + 16 * warp + g;
      if (p.softcap > 0.f) {
        if (whole) dkv_grads<true, false>(st, dpt, ls, dl, key0, q0, qh, tq, p);
        else dkv_grads<true, true>(st, dpt, ls, dl, key0, q0, qh, tq, p);
      } else {
        if (whole) dkv_grads<false, false>(st, dpt, ls, dl, key0, q0, qh, tq, p);
        else dkv_grads<false, true>(st, dpt, ls, dl, key0, q0, qh, tq, p);
      }
      // dv += p^T do and dk += ds^T q, p^T and ds^T rounded to bf16 into A
      // fragments (queries qh + 16 kk.. of the accumulator layout)
#pragma unroll
      for (int kk = 0; kk < QS; ++kk) {
        const uint32_t pa[4] = {repro::pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                repro::pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                repro::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                repro::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t da[4] = {repro::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                repro::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                repro::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                repro::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t df[4], qf[4];
          repro::ldmatrix_x4_trans(df, bt_pair<LD>(Db, qh + 16 * kk, c0 + 8 * j, lane));
          repro::ldmatrix_x4_trans(qf, bt_pair<LD>(Qb, qh + 16 * kk, c0 + 8 * j, lane));
          repro::mma_bf16(dva[j], pa, df[0], df[1]);
          repro::mma_bf16(dva[j + 1], pa, df[2], df[3]);
          repro::mma_bf16(dka[j], da, qf[0], qf[1]);
          repro::mma_bf16(dka[j + 1], da, qf[2], qf[3]);
        }
      }
    }
  }

  // this thread's rows of dk and dv among the tile's kvalid keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = 16 * warp + g + 8 * r;
    if (kr >= kvalid) continue;
    const size_t off = (((size_t)b * p.T + k0 + kr) * p.K + kh) * p.d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {   // a thread's two adjacent columns in one store
      const int c = c0 + 8 * j + 2 * tq;
      if (c + 1 < p.d && p.d % 2 == 0) {
        store_pair(dk + off + c, dka[j][2 * r], dka[j][2 * r + 1]);
        store_pair(dv + off + c, dva[j][2 * r], dva[j][2 * r + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < p.d) {
            dk[off + c + e] = dka[j][2 * r + e];
            dv[off + c + e] = dva[j][2 * r + e];
          }
      }
    }
  }
}

// B6 in the bf16 operand mode.  A block is 4 warps of 16 query rows (64
// rows, one (q tile, head, batch) item; the grid lists the items q tiles in
// reverse, so the causal rows that see the most keys start first) walking
// the visible 64-key tiles.  Each warp keeps in registers, for the item,
// its rows' q and do as A fragments (rounded to bf16 from device memory:
// no staging), their lse and delta, and its dq accumulator (16 x DP f32).
// k and v of a tile arrive as two TMA boxes on an mbarrier (or element by
// element, rows the copy engine cannot move) into one staging tile, which
// the block rounds once into padded bf16 tiles; the next tile's boxes fly
// while the warps multiply.  A warp forms s = q k^T and dp = do v^T for
// kDqKW keys at a time (ldmatrix of k and v, the B operand untransposed),
// ds in place of s, and adds ds k to dq: ds, rounded pairwise from the
// accumulator layout, is the A fragment (mma.cuh), and k the B operand by
// ldmatrix.trans, so ds never touches shared memory.  A warp skips the
// keys none of its rows sees (exact zeros).
// Registers a thread: s and dp 2 x kDqKW / 2, the q and do fragments 2 x
// DP / 4, dq DP / 2, lse and delta 4: 100 at DP = 64, 164 at DP = 128
// (ptxas allots 160 and 228 with the addresses and the unrolled loops; no
// spills on an H100 build), so kDqKW = 32: a 64-key s and dp would need 32
// more, past the 168 that three blocks an SM allow at DP = 64.  Three
// blocks an SM at DP = 64 (12 warps; 51 KB of shared memory each in f32),
// two at DP = 128 (100 KB): while one block rounds a tile or waits at a
// barrier, the others multiply, where B5's one persistent block an SM
// idles the tensor cores.
constexpr int kDqKW = 32;
constexpr int kDqTcBQ = kTcThreads / 2;   // 4 warps of 16 rows
// (at DP = 256: no staging; bf16 k, v, q and do tiles, 132 KB)
template <typename T, int DP> constexpr size_t dq_tc_smem_bytes() {
  if constexpr (DP > 128) return 128 + 4 * smem_piece(2 * kBK * tc_ld<DP>()) + smem_piece(8);
  return 128 + smem_piece(sizeof(T) * 2 * kBK * DP) + 2 * smem_piece(2 * kBK * tc_ld<DP>())
       + smem_piece(8);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 3 : DP == 128 ? 2 : 1)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, Params p,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv) {
  // kWide (DP = 256): the block's dq columns are one half, DC = 128, c0..
  // (blockIdx.x's lowest index); no staging: k and v are rounded straight
  // from device memory into Kb and Vb at each tile, q and do into Qb and Db
  // once, from which the warps read their fragments at each k-step (q's
  // and do's 2 x DP / 4 registers would not fit beside dq's); p.tma then
  // flags rows of whole 16-byte pieces (round_rows)
  constexpr bool kWide = DP > 128;
  constexpr int DC = out_cols<DP>(), NH = DP / DC;
  constexpr int LD = tc_ld<DP>(), NT = kDqKW / 8, DT = DC / 8, KS = DP / 16, QS = kDqKW / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int nq = (p.S + kDqTcBQ - 1) / kDqTcBQ, hb = p.H * p.B;
  const int item = (int)blockIdx.x / NH, c0 = (int)blockIdx.x % NH * DC;
  const int q0 = (nq - 1 - item / hb) * kDqTcBQ;
  const int h = item % hb % p.H, b = item % hb / p.H, kh = h / (p.H / p.K);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  Carve cv{align128(smem_tc)};
  T* F = kWide ? nullptr : cv.take<T>(2 * kBK * DP);   // staging: k, then v (128-byte aligned)
  bf16* Kb = cv.take<bf16>(kBK * LD);
  bf16* Vb = cv.take<bf16>(kBK * LD);
  bf16* Qb = kWide ? cv.take<bf16>(kDqTcBQ * LD) : nullptr;
  bf16* Db = kWide ? cv.take<bf16>(kDqTcBQ * LD) : nullptr;
  uint64_t* bar = cv.take<uint64_t>(1);

  const size_t kstride = (size_t)p.K * p.d, koff = ((size_t)b * p.T * p.K + kh) * p.d;
  const int ldf = p.tma ? p.d : DP;     // the staging's row pitch
  const int2 kr = visible_range((p.T + kBK - 1) / kBK, [&](int t) {
    return tile_visible(q0, kDqTcBQ, t * kBK, kBK, p);
  });
  // k and v of key tile kt: one box each (64 rows of one head, the
  // barrier's next phase) for the copy engine, or element by element
  auto stage = [&](int kt) {
    const int k0 = kt * kBK;
    if (p.tma) {
      if (threadIdx.x == 0) {
        repro::mbar_arrive_expect(bar, 2 * kBK * p.d * sizeof(T));
        repro::tma_load_3d(F, &tmk, 0, kh, b * p.T + k0, bar);
        repro::tma_load_3d(F + kBK * DP, &tmv, 0, kh, b * p.T + k0, bar);
      }
    } else {
      const int kvalid = min(kBK, p.T - k0);
      load_rows_plain<T, DP, kTcThreads>(F, k + koff, kstride, k0, kvalid, p.d, threadIdx.x);
      load_rows_plain<T, DP, kTcThreads>(F + kBK * DP, v + koff, kstride, k0, kvalid, p.d,
                                         threadIdx.x);
    }
  };
  if (threadIdx.x == 0) repro::mbar_init(bar, 1);
  __syncthreads();
  if (!kWide && kr.x < kr.y) stage(kr.x);

  // this warp's 16 rows of q and do as A fragments for the item, rounded to
  // bf16 (zeros beyond S and d), while the first tile flies (at DP = 256
  // the block's rows into Qb and Db, ordered before their readers by the
  // first tile's barrier); this thread's rows are q0 + 16 warp + g + 8 r (r
  // = 0, 1), its columns of each 8-wide n-tile j c0 + 8 j + 2 tq + e (e = 0,
  // 1)
  uint32_t qa[kWide ? 1 : KS][4], da[kWide ? 1 : KS][4];
  const size_t qstride = (size_t)p.H * p.d;
  const T* qb = q + ((size_t)b * p.S * p.H + h) * p.d;
  const T* db = dout + ((size_t)b * p.S * p.H + h) * p.d;
  if constexpr (kWide) {
    const int qvalid = min(kDqTcBQ, p.S - q0);
    round_rows<T, DP, kDqTcBQ, kTcThreads>(Qb, qb, qstride, q0, qvalid, p.d, 0, p.tma,
                                           threadIdx.x);
    round_rows<T, DP, kDqTcBQ, kTcThreads>(Db, db, qstride, q0, qvalid, p.d, 0, p.tma,
                                           threadIdx.x);
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e & 1), c = 16 * ks + 8 * (e >> 1) + 2 * tq;
        const bool in = q0 + r < p.S;
        const size_t at = (size_t)(q0 + r) * qstride + c;
        qa[ks][e] = repro::pack_bf16(in && c < p.d ? to_f32(qb[at]) : 0.f,
                                     in && c + 1 < p.d ? to_f32(qb[at + 1]) : 0.f);
        da[ks][e] = repro::pack_bf16(in && c < p.d ? to_f32(db[at]) : 0.f,
                                     in && c + 1 < p.d ? to_f32(db[at + 1]) : 0.f);
      }
  }
  const float* lse_b = lse + ((size_t)b * p.H + h) * p.S;
  const float* delta_b = delta + ((size_t)b * p.H + h) * p.S;
  float lr[2], dr[2], acc[DT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lr[r] = row < p.S ? lse_b[row] : 0.f;
    dr[r] = row < p.S ? delta_b[row] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int r0 = q0 + 16 * warp;   // this warp's first row
  uint32_t phase = 0;
  for (int kt = kr.x; kt < kr.y; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the element-wise rows in; every warp done with Kb and Vb
    const int kvalid = min(kBK, p.T - k0);
    if constexpr (kWide) {
      round_rows<T, DP, kBK, kTcThreads>(Kb, k + koff, kstride, k0, kvalid, p.d, 0, p.tma,
                                         threadIdx.x);
      round_rows<T, DP, kBK, kTcThreads>(Vb, v + koff, kstride, k0, kvalid, p.d, 0, p.tma,
                                         threadIdx.x);
    } else {
      if (p.tma) {
        repro::mbar_wait(bar, phase);
        phase ^= 1;
      }
      to_bf16_tile<T, DP, kBK, kTcThreads>(Kb, F, ldf, kvalid, p.d, threadIdx.x);
      to_bf16_tile<T, DP, kBK, kTcThreads>(Vb, F + kBK * DP, ldf, kvalid, p.d, threadIdx.x);
    }
    __syncthreads();   // Kb and Vb ready, the staging free
    if (!kWide && kt + 1 < kr.y) stage(kt + 1);

#pragma unroll 1
    for (int kb = 0; kb < kBK; kb += kDqKW) {
      const int key0 = k0 + kb;
      if (key0 >= p.T || !tile_visible(r0, 16, key0, kDqKW, p)) continue;   // warp-uniform
      // s = q k^T and dp = do v^T: this warp's 16 rows by kDqKW keys
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      auto step = [&](int ks, const uint32_t (&qf)[4], const uint32_t (&df)[4]) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kf[4], vf[4];
          repro::ldmatrix_x4(kf, b_pair<LD>(Kb, kb + 8 * j, 16 * ks, lane));
          repro::ldmatrix_x4(vf, b_pair<LD>(Vb, kb + 8 * j, 16 * ks, lane));
          repro::mma_bf16(s[j], qf, kf[0], kf[1]);
          repro::mma_bf16(s[j + 1], qf, kf[2], kf[3]);
          repro::mma_bf16(dp[j], df, vf[0], vf[1]);
          repro::mma_bf16(dp[j + 1], df, vf[2], vf[3]);
        }
      };
#pragma unroll (DP > 128 ? 4 : DP / 16)
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (kWide) {
          uint32_t qf[4], df[4];
          repro::ldmatrix_x4(qf, a_frag<LD>(Qb, 16 * warp, 16 * ks, lane));
          repro::ldmatrix_x4(df, a_frag<LD>(Db, 16 * warp, 16 * ks, lane));
          step(ks, qf, df);
        } else {
          step(ks, qa[ks], da[ks]);
        }
      }
      // ds in place of s (dq_grads); keys that every row of the warp sees
      // unmasked
      const bool whole = key0 + kDqKW <= p.T && (!p.causal || key0 + kDqKW - 1 <= r0) &&
                         (!p.window || r0 + 15 - key0 < p.window);
      if (p.softcap > 0.f) {
        if (whole) dq_grads<true, false>(s, dp, lr, dr, r0 + g, key0, tq, p);
        else dq_grads<true, true>(s, dp, lr, dr, r0 + g, key0, tq, p);
      } else {
        if (whole) dq_grads<false, false>(s, dp, lr, dr, r0 + g, key0, tq, p);
        else dq_grads<false, true>(s, dp, lr, dr, r0 + g, key0, tq, p);
      }
      // dq += ds k, ds rounded to bf16 into the A fragments of keys kb + 16
      // kk.., k (keys by d) the B operand through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < QS; ++kk) {
        const uint32_t a[4] = {repro::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               repro::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               repro::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               repro::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t kf[4];
          repro::ldmatrix_x4_trans(kf, bt_pair<LD>(Kb, kb + 16 * kk, c0 + 8 * j, lane));
          repro::mma_bf16(acc[j], a, kf[0], kf[1]);
          repro::mma_bf16(acc[j + 1], a, kf[2], kf[3]);
        }
      }
    }
  }

  // this thread's rows of dq that lie below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= p.S) continue;
    float* drow = dq + (((size_t)b * p.S + row) * p.H + h) * p.d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {   // a thread's two adjacent columns in one store
      const int c = c0 + 8 * j + 2 * tq;
      if (c + 1 < p.d && p.d % 2 == 0) {
        store_pair(drow + c, acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (c < p.d) drow[c] = acc[j][2 * r];
        if (c + 1 < p.d) drow[c + 1] = acc[j][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The int8 mode (B5, B6 and B7): a quantization pre-pass for the forward
// and one for the backward, then the kernels on the s8 tensor cores
// (mma.sync m16n8k32).  Why the bits are those of the dp4a kernels they
// replace (the first int8 kernels, which quantized every operand tile
// inside each block and multiplied four packed bytes at a time): each
// int8 product is exact and no int32 sum comes near overflow (128 x 127^2
// per tile), so neither the MMA's order of the sums nor a permutation of
// the axis A and B share changes one; a scale over a tile is a function of
// that tile alone, so quantizing once a call gives the bytes each block
// made; and what decides the numbers is kept: the scales' axes,
// quantize_int8's byte (the IEEE quotient by max(scale, 1e-12), half to
// even, +-127; quant_rcp), and the f32 epilogue in its order (rescale,
// then __fadd_rn tile by tile).  B5 sums l in the fragments' order, which
// its plain version follows (ref._mma_row_sum).  The outputs equal
// ref.flash_fwd_ref and ref.flash_bwd_ref bit for bit on an H100.
// ---------------------------------------------------------------------------

// The operands of the int8 backward, quantized once a call by
// flash_quant_i8_kernel (nS = ceil(S / 128), nT = ceil(T / 128); d zero-padded
// to DP, rows past S or T zeros in the tiles).  Per row over d, natural
// order: q8 and do8 (B, S, H, DP) with sq, sdo (B, H, S); k8 and v8 (B, T,
// K, DP) with sk, sv (B, K, T).  Per column over each 128-row tile, stored
// K-major with each 16-group of the tile's rows in frag_perm order: kT8
// (B, K, nT, DP, 128) with skc (B, K, nT, DP); qT8 and doT8 (B, H, nS, DP,
// 128) with sqc, sdoc (B, H, nS, DP).  The host passes the 14 pointers in
// this order; the pre-pass writes them, B6 and B7 read them.
struct I8Ops {
  int8_t *q8, *do8, *k8, *v8, *kT8, *qT8, *doT8;
  float *sq, *sdo, *sk, *sv, *skc, *sqc, *sdoc;
};

// The contraction axis of ds k (B6), p^T do and ds^T q (B7) in the order of
// the m16n8k32 fragments.  A score tile's s32 accumulators give a thread
// columns 2t, 2t+1, 8+2t and 9+2t of each 16-column group (g = lane / 4, t
// = lane % 4), where the A fragment of the next product wants 4t..4t+3; so
// a thread packs those four values as its A bytes, and B's rows of the same
// group are stored in the same order: position p = 4t + e of a group holds
// row frag_perm(p) = 8 (e / 2) + 2t + e % 2.  A permutation of the axis
// that A and B share leaves the int32 sum, exact, as it was.
__host__ __device__ constexpr int frag_perm(int pos) {
  return 8 * ((pos & 3) >> 1) + 2 * (pos >> 2) + (pos & 1);
}

// quantize_int8's byte of x at `scale`, rint(x / max(scale, 1e-12)) (sc)
// clipped to +-127, from the reciprocal rcp = 1 / sc formed once a row.
// Where the quotient's magnitude is at most ~128 (x is bounded by the
// row's absmax, 127 scales), x * rcp lies within 2^-15 of the IEEE
// quotient x / sc, so both round to the same integer unless x * rcp lies
// within 2^-12 of a half step; there (a few values in ten thousand) the
// IEEE quotient is formed.  The same byte for every x, inf and NaN
// included, for a fraction of the divide's work.
__device__ __forceinline__ int8_t quant_rcp(float x, float sc, float rcp) {
  const float y = __fmul_rn(x, rcp);
  float r = rintf(y);
  if (fabsf(fabsf(y - r) - 0.5f) < 0x1p-12f) r = rintf(x / sc);
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// (max(scale, 1e-12), its reciprocal) for quant_rcp
__device__ __forceinline__ float2 quant_scale(float scale) {
  const float sc = fmaxf(scale, 1e-12f);
  return make_float2(sc, 1.f / sc);
}

// four int8 values into one register, the first in the low byte
__device__ __forceinline__ uint32_t pack_s8(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (uint32_t)(uint8_t)a | (uint32_t)(uint8_t)b << 8 | (uint32_t)(uint8_t)c << 16 |
         (uint32_t)(uint8_t)d << 24;
}

// quantized bytes of a 16-row by 32-column f32 tile in the accumulator
// layout (x[j][e]: n-tile j of 8 columns; rows g, g + 8 at s[0], s[1], each
// quant_scale's pair) as the A fragment of an m16n8k32 product over those
// columns in frag_perm order
__device__ __forceinline__ void quant_frag(uint32_t (&a)[4], const float (&x0)[4],
                                           const float (&x1)[4], const float (&x2)[4],
                                           const float (&x3)[4], const float2 (&s)[2]) {
  auto q = [&](float x, int r) { return quant_rcp(x, s[r].x, s[r].y); };
  a[0] = pack_s8(q(x0[0], 0), q(x0[1], 0), q(x1[0], 0), q(x1[1], 0));
  a[1] = pack_s8(q(x0[2], 1), q(x0[3], 1), q(x1[2], 1), q(x1[3], 1));
  a[2] = pack_s8(q(x2[0], 0), q(x2[1], 0), q(x3[0], 0), q(x3[1], 0));
  a[3] = pack_s8(q(x2[2], 1), q(x2[3], 1), q(x3[2], 1), q(x3[3], 1));
}

// the largest of a row's values over the four lanes that hold it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ldmatrix addresses into an int8 tile X with row stride LD bytes, for lane
// `lane`: a8_frag the A fragment of rows [r0, r0 + 16), bytes [c0, c0 +
// 32); b8_pair the B fragments of n-tiles [n0, n0 + 8) and [n0 + 8, n0 +
// 16) at k bytes [k0, k0 + 32), X holding n as rows (k contiguous)
__device__ __forceinline__ const int8_t* a8_frag(const int8_t* X, int LD, int r0, int c0,
                                                 int lane) {
  return X + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 16;
}
__device__ __forceinline__ const int8_t* b8_pair(const int8_t* X, int LD, int n0, int k0,
                                                 int lane) {
  return X + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 16;
}

// Row strides of the int8 tiles in shared memory: DP bytes (or a tile's
// 128) plus 16, so the 8 rows of an ldmatrix fall in 8 different 16-byte
// bank groups.
template <int DP> __host__ __device__ constexpr int i8_ld() { return DP + 16; }
constexpr int kI8TLd = kI8 + 16;

// Copies by 16-byte (int8 rows) or 4-byte (scales) cp.async into shared
// memory, NTHR threads (this one `tid`), zeros at rows >= valid; the
// caller commits the group.
//  rows8: rows [0, n) of one head, `stride` bytes apart, DP bytes each
//  tile8: a transposed tile, R rows of 128 bytes, contiguous
//  f32s:  n floats
template <int DP, int NTHR>
__device__ __forceinline__ void copy_rows8(int8_t* X, const int8_t* src, size_t stride, int n,
                                           int valid, int tid) {
  constexpr int CPR = DP / 16, LD = i8_ld<DP>();
  for (int i = tid; i < n * CPR; i += NTHR) {
    const int r = i / CPR, c = (i % CPR) * 16;
    if (r < valid) repro::cp_async16(X + r * LD + c, src + r * stride + c);
    else *reinterpret_cast<uint4*>(X + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}
template <int R, int NTHR>
__device__ __forceinline__ void copy_tile8(int8_t* X, const int8_t* src, int tid) {
  for (int i = tid; i < R * (kI8 / 16); i += NTHR) {
    const int r = i / (kI8 / 16), c = (i % (kI8 / 16)) * 16;
    repro::cp_async16(X + r * kI8TLd + c, src + r * kI8 + c);
  }
}
template <int NTHR>
__device__ __forceinline__ void copy_f32s(float* X, const float* src, int n, int valid,
                                          int tid) {
  for (int i = tid; i < n; i += NTHR) {
    if (i < valid) repro::cp_async4(X + i, src + i);
    else X[i] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// The pre-passes.  Replace no TPU kernel: they are the quantization inside
// the reference's kernel_dot (src/repro/quant/core.py:31-41, :63-67) hoisted
// out of B5's, B6's and B7's tile loops, where the dp4a kernels quantized
// each k and v (B5), k (B6) and q and do (B7) tile again in every block that
// visits it (5 blocks on average at mup-gpt's causal 512 tokens).  A scale
// over a 128-row tile is a function of that tile alone, so once a call
// gives the very bytes.  Bound by bytes: the backward's reads q, k, v and
// do once and writes 7 int8 tensors and their scales (at the train shape
// ~67 MB + 29 MB, ~29 us at 3.35 TB/s); the forward's reads k and v and
// writes k8 and vT8 with their scales (33.6 MB + 8.4 MB, ~12.5 us).
// One block a 128-row tile of one head of one tensor (flash_quant_i8_kernel:
// q, do, k or v; flash_quant_fwd_i8_kernel: k or v), quant_tile: staged once
// in shared memory as f32 by 16-byte loads, quantized per row over d by a
// warp a row (four rows at a time) where the tensor has a row form and per
// column over the tile's rows where it has a column form: a warp a 16-row
// group reads each column's values in frag_perm order and writes them as
// one 16-byte store (37 KB of shared memory at DP = 64, so six blocks share
// an SM).  Rows: q, do, k, v (backward), k (forward).  Columns: q, do, k
// (backward), v (forward).
// ---------------------------------------------------------------------------
template <int DP> constexpr size_t quant_i8_smem_bytes() {
  return smem_piece(4 * kI8 * (DP + 4)) + smem_piece(4 * 8 * DP);
}

// 16 bytes of T at src as f32 into dst (16-byte aligned)
__device__ __forceinline__ void load16_f32(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16_f32(float* dst, const bf16* src) {
  float x[8];
  load8(src, x);
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// Tile `tile` (of n) of head h of batch b of `src` (B, rows, heads, d):
// per row over d into rows8 (B, rows, heads, DP) with rscale (B, heads,
// rows) where rows8 is given, per column over the tile into cols8 (B,
// heads, n, DP, 128) with cscale (B, heads, n, DP) where cols8 is given.
template <typename T, int DP>
__device__ __forceinline__ void quant_tile(const T* __restrict__ src, int heads, int rows,
                                           int n, int tile, int h, int b, int8_t* rows8,
                                           float* rscale, int8_t* cols8, float* cscale,
                                           const Params& p) {
  static_assert(kThreads == 8 * 32 && kI8 == 8 * 16, "a warp a 16-row group");
  constexpr int LD = DP + 4, E = DP / 32, V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_q8[];
  Carve cv{smem_q8};
  float* xs = cv.take<float>(kI8 * LD);           // the tile, f32, zeros past rows and d
  float* red = cv.take<float>(8 * DP);            // each warp's column maxima

  const int r0 = tile * kI8, valid = min(kI8, rows - r0);
  const size_t stride = (size_t)heads * p.d;
  const T* base = src + (((size_t)b * rows + r0) * heads + h) * p.d;
  if (p.tma) {   // rows of whole 16-byte pieces (d a multiple of V, 16-byte aligned)
#pragma unroll
    for (int i = threadIdx.x; i < kI8 * (DP / V); i += kThreads) {
      const int r = i / (DP / V), c = (i % (DP / V)) * V;
      float* x = xs + r * LD + c;
      if (r < valid && c < p.d) {
        load16_f32(x, base + r * stride + c);
      } else {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(x + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < kI8 * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      xs[r * LD + c] = (r < valid && c < p.d) ? to_f32(base[r * stride + c]) : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // per row over d: a warp a row, four rows at a time (rows warp + 8 i)
  if (rows8 != nullptr) {   // uniform over the block
#pragma unroll
    for (int i0 = 0; i0 < kI8 / 8; i0 += 4) {
      float x[4][E], sc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          x[i][e] = xs[(warp + 8 * (i0 + i)) * LD + lane + 32 * e];
          amax = fmaxf(amax, fabsf(x[i][e]));
        }
        sc[i] = amax;
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i] = fmaxf(sc[i], __shfl_xor_sync(0xffffffffu, sc[i], o2));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp + 8 * (i0 + i);
        if (r >= valid) continue;
        const float s = sc[i] / 127.f;
        const float2 qs = quant_scale(s);
        int8_t* dst = rows8 + (((size_t)b * rows + r0 + r) * heads + h) * DP;
#pragma unroll
        for (int e = 0; e < E; ++e) dst[lane + 32 * e] = quant_rcp(x[i][e], qs.x, qs.y);
        if (lane == 0) rscale[((size_t)b * heads + h) * rows + r0 + r] = s;
      }
    }
  }
  if (cols8 == nullptr) return;   // uniform over the block

  // per column over the tile's rows: warp w holds rows 16 w..16 w + 15 of
  // columns lane + 32 cc
  float am[E];
#pragma unroll
  for (int cc = 0; cc < E; ++cc) {
    const int c = lane + 32 * cc;
    am[cc] = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) am[cc] = fmaxf(am[cc], fabsf(xs[(16 * warp + r) * LD + c]));
    red[warp * DP + c] = am[cc];
  }
  __syncthreads();
  int8_t* dst = cols8 + (((size_t)b * heads + h) * n + tile) * DP * kI8;
#pragma unroll
  for (int cc = 0; cc < E; ++cc) {
    const int c = lane + 32 * cc;
    float a = red[c];
#pragma unroll
    for (int w = 1; w < 8; ++w) a = fmaxf(a, red[w * DP + c]);
    const float s = a / 127.f;
    const float2 qs = quant_scale(s);
    uint32_t wd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* xr = xs + (16 * warp) * LD + c;
      auto qv = [&](int pos) { return quant_rcp(xr[frag_perm(pos) * LD], qs.x, qs.y); };
      wd[e] = pack_s8(qv(4 * e), qv(4 * e + 1), qv(4 * e + 2), qv(4 * e + 3));
    }
    *reinterpret_cast<uint4*>(dst + c * kI8 + 16 * warp) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    if (warp == 0) cscale[(((size_t)b * heads + h) * n + tile) * DP + c] = s;
  }
}

// The backward's pre-pass: blocks for the tiles of q, then do (B, H, nS
// each), then k, then v (B, K, nT each)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_quant_i8_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout, I8Ops o, Params p) {
  const int nS = (p.S + kI8 - 1) / kI8, nT = (p.T + kI8 - 1) / kI8;
  const long long qi = (long long)p.B * p.H * nS, ki = (long long)p.B * p.K * nT;
  long long item = blockIdx.x;
  int which;   // 0 q, 1 do, 2 k, 3 v
  if (item < 2 * qi) {
    which = (int)(item / qi);
    item %= qi;
  } else {
    item -= 2 * qi;
    which = 2 + (int)(item / ki);
    item %= ki;
  }
  const bool kv = which >= 2;
  const int heads = kv ? p.K : p.H, rows = kv ? p.T : p.S, n = kv ? nT : nS;
  const int tile = (int)(item % n), h = (int)(item / n % heads), b = (int)(item / n / heads);
  const T* src = which == 0 ? q : which == 1 ? dout : which == 2 ? k : v;
  int8_t* rows8 = which == 0 ? o.q8 : which == 1 ? o.do8 : which == 2 ? o.k8 : o.v8;
  float* rscale = which == 0 ? o.sq : which == 1 ? o.sdo : which == 2 ? o.sk : o.sv;
  int8_t* cols8 = which == 0 ? o.qT8 : which == 1 ? o.doT8 : which == 2 ? o.kT8 : nullptr;
  float* cscale = which == 0 ? o.sqc : which == 1 ? o.sdoc : o.skc;
  quant_tile<T, DP>(src, heads, rows, n, tile, h, b, rows8, rscale, cols8, cscale, p);
}

// The operands of B5 in the int8 mode, quantized once a call by
// flash_quant_fwd_i8_kernel (nT = ceil(T / 128), d zero-padded to DP, rows
// past T zeros in the tiles): k per row over d, k8 (B, T, K, DP) with sk (B,
// K, T), the backward's bytes; v per column over each 128-key tile, vT8 (B,
// K, nT, DP, 128) with svc (B, K, nT, DP), K-major with each 16-group of the
// tile's keys in frag_perm order (the backward's kT8 layout).  The host
// passes the 4 pointers in this order.
struct FwdI8Ops {
  int8_t *k8, *vT8;
  float *sk, *svc;
};

// The forward's pre-pass: blocks for the tiles of k, then of v (B, K, nT each)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_quant_fwd_i8_kernel(const T* __restrict__ k, const T* __restrict__ v, FwdI8Ops o,
                          Params p) {
  const int nT = (p.T + kI8 - 1) / kI8;
  const long long ki = (long long)p.B * p.K * nT;
  long long item = blockIdx.x;
  const bool isv = item >= ki;
  if (isv) item -= ki;
  const int tile = (int)(item % nT), h = (int)(item / nT % p.K), b = (int)(item / nT / p.K);
  if (isv)
    quant_tile<T, DP>(v, p.K, p.T, nT, tile, h, b, nullptr, nullptr, o.vT8, o.svc, p);
  else
    quant_tile<T, DP>(k, p.K, p.T, nT, tile, h, b, o.k8, o.sk, nullptr, nullptr, p);
}

// ---------------------------------------------------------------------------
// B5, int8 operands, on the s8 tensor cores.
// A block is 4 warps of 16 query rows (a 64-row q tile, one (q tile, head,
// batch) item, q tiles in reverse so the causal rows that see the most keys
// start first) walking the visible 128-key tiles (128 wide: p v takes its
// scales over the tile's keys).  Each warp quantizes its 16 q rows per row
// over d once, at the item's set-up, straight from device memory into the A
// fragments of q k^T (no q row is quantized twice in a call, so a pre-pass
// over q would only add its writes and reads).  The tile's k8, vT8 and their
// scales come from the forward pre-pass by 16-byte cp.async, double-buffered:
// the next tile's copies fly while the warps multiply.  A warp owns its 16
// rows across the whole tile: s = q8 k8^T by 32-key chunks (ldmatrix of the
// row-quantized bytes, K-contiguous on both sides; a chunk none of the
// warp's rows sees is masked whole without its products), the online
// softmax in f32 registers in the accumulator layout (a row's max, sum and
// absmax over its four lanes by quad shuffles: no shared memory, no block
// barrier), p quantized per row over the tile's keys straight into the A
// fragments of acc += p8 vT8 (frag_perm; a chunk whose p bytes are all zero
// adds nothing and is skipped).  The f32 steps are the dp4a kernel's, in
// its order: rescale = (float)acc * sa * sb rounded at each step, the
// logit's __fmul_rn, the softcap's tanhf and divide, the mask, m_new =
// max(m, rowmax), p = expf(s - m_new), sp = pmax / 127, alpha = expf(m -
// m_new), l = alpha l + rowsum (the fragments' order: n-tiles, then the
// pair, then lanes xor 1, 2; ref._mma_row_sum), acc = acc alpha +
// rescale(p8 vT8) tile by tile in increasing key order, then store_out's
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
// Registers a thread: s 64, acc DP / 2, q8 DP / 8, p8 16; DP = 64 fits
// three blocks (12 warps) an SM, DP = 128 two.
// ---------------------------------------------------------------------------
constexpr int kI8Threads = 128;   // B5, B6: 4 warps of 16 rows; B7: 2 pairs of warps

// B5's shared memory, byte offsets from its base: at DP = 256 the item's
// q bytes (Q8); two stages of a key tile (k8, vT8 and svc of the block's DC
// columns, sk), from STAGES
template <int DP> struct FwdI8Smem {
  static constexpr int DC = out_cols<DP>();
  static constexpr size_t Q8 = 0, STAGES = DP > 128 ? smem_piece(kBQ * i8_ld<DP>()) : 0;
  static constexpr size_t K8 = 0, VT = smem_piece(kI8 * i8_ld<DP>()),
                          SK = VT + smem_piece(DC * kI8TLd), SV = SK + smem_piece(4 * kI8),
                          STAGE = SV + smem_piece(4 * DC), BYTES = STAGES + 2 * STAGE;
};

// 4 values of T at src (4-element aligned) as f32
__device__ __forceinline__ void load4(const float* src, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* src, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(src);
  x[0] = __uint_as_float(a.x << 16);
  x[1] = __uint_as_float(a.x & 0xffff0000u);
  x[2] = __uint_as_float(a.y << 16);
  x[3] = __uint_as_float(a.y & 0xffff0000u);
}

// B5's masked logits of one 32-key chunk (keys key0 + 8 j + 2 tq + e, local
// kl0 + ..; rows row0, row0 + 8 at q scales sqr) into x
template <bool kCap, bool kMask>
__device__ __forceinline__ void fwd_i8_logits(float (&x)[4][4], const int (&si)[4][4],
                                              const float* sk, int kl0, int key0, int row0,
                                              int tq, const float (&sqr)[2], const Params& p) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kc = 8 * j + 2 * tq + (e & 1);
      float t;
      const float lg = tc_logit<kCap>(rescale(si[j][e], sqr[r], sk[kl0 + kc]), p, t);
      x[j][e] = !kMask || visible(row0 + 8 * r, key0 + kc, p) ? lg : kNegInf;
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kI8Threads, DP == 64 ? 3 : DP == 128 ? 2 : 1)
flash_fwd_i8_kernel(const T* __restrict__ q, const FwdI8Ops o, T* __restrict__ out,
                    float* __restrict__ lse, Params p) {
  // kWide (DP = 256): the block's o columns are one half, DC = 128, c0..
  // (blockIdx.x's lowest index), with vT8's and svc's rows of them; q's
  // bytes go to shared memory (Q8), from which the warps read their
  // fragments at each k-step (DP / 8 registers would not fit beside the
  // score tile and o's)
  constexpr bool kWide = DP > 128;
  constexpr int DC = out_cols<DP>(), NH = DP / DC;
  constexpr int LD = i8_ld<DP>(), KS = DP / 32, DT = DC / 8, NT = kI8 / 8, TS = kI8 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int nq = (p.S + kBQ - 1) / kBQ, hb = p.H * p.B, nT = (p.T + kI8 - 1) / kI8;
  const int item = (int)blockIdx.x / NH, c0 = (int)blockIdx.x % NH * DC;
  const int q0 = (nq - 1 - item / hb) * kBQ;
  const int h = item % hb % p.H, b = item % hb / p.H, kh = h / (p.H / p.K);
  using L = FwdI8Smem<DP>;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem_i8 + L::Q8);   // kWide only

  // each visible key tile into buffer (it & 1)
  const int2 kr = visible_range(nT, [&](int t) { return tile_visible(q0, kBQ, t * kI8, kI8, p); });
  auto stage = [&](int kt, int s) {
    unsigned char* st = smem_i8 + L::STAGES + s * L::STAGE;
    const int k0 = kt * kI8, kvalid = min(kI8, p.T - k0);
    const size_t krow = (((size_t)b * p.T + k0) * p.K + kh) * DP;
    const size_t kcol = ((size_t)b * p.K + kh) * nT + kt;
    copy_rows8<DP, kI8Threads>(reinterpret_cast<int8_t*>(st + L::K8), o.k8 + krow,
                               (size_t)p.K * DP, kI8, kvalid, threadIdx.x);
    copy_tile8<DC, kI8Threads>(reinterpret_cast<int8_t*>(st + L::VT),
                               o.vT8 + (kcol * DP + c0) * kI8, threadIdx.x);
    copy_f32s<kI8Threads>(reinterpret_cast<float*>(st + L::SK),
                          o.sk + ((size_t)b * p.K + kh) * p.T + k0, kI8, kvalid, threadIdx.x);
    copy_f32s<kI8Threads>(reinterpret_cast<float*>(st + L::SV), o.svc + kcol * DP + c0, DC, DC,
                          threadIdx.x);
    repro::cp_async_commit();
  };
  if (kr.x < kr.y) stage(kr.x, 0);

  // this thread's rows are r0 + g + 8 r (r = 0, 1); its columns of each
  // 8-wide n-tile j 8 j + 2 tq + e (e = 0, 1).  Its q bytes, as the A
  // fragments of each 32-byte k-step ks: a0 (g, 4 tq..), a1 (g + 8, 4 tq..),
  // a2 (g, 16 + 4 tq..), a3 (g + 8, 16 + 4 tq..), quantized per row over d
  // (a row's absmax over its four lanes), zeros beyond S and d; the row
  // scales sqr.  p.tma: d a multiple of 4 and q 16-byte aligned, so four
  // values load at once.
  const int r0 = q0 + 16 * warp;
  uint32_t qa[kWide ? 1 : KS][4];
  float sqr[2];
  {
    const size_t qstride = (size_t)p.H * p.d;
    const T* qb = q + ((size_t)b * p.S * p.H + h) * p.d;
    // the 4 values of row r (0, 1) at k-step ks, half hh (0, 1)
    auto q_vals = [&](int r, int ks, int hh, float (&xv)[4]) {
      const int row = r0 + g + 8 * r, c = 32 * ks + 16 * hh + 4 * tq;
      const T* qr = qb + (size_t)row * qstride;
      if (row < p.S && p.tma && c < p.d) {
        load4(qr + c, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = row < p.S && c + e < p.d ? to_f32(qr[c + e]) : 0.f;
      }
    };
    float amax[2] = {0.f, 0.f};
    auto q4 = [&](const float (&v)[4], const float2& qs) {
      return pack_s8(quant_rcp(v[0], qs.x, qs.y), quant_rcp(v[1], qs.x, qs.y),
                     quant_rcp(v[2], qs.x, qs.y), quant_rcp(v[3], qs.x, qs.y));
    };
    if constexpr (kWide) {
      // two passes over the rows (2 x DP / 4 values would not fit in
      // registers): the absmax, then the bytes into this warp's rows of Q8,
      // where ldmatrix finds them in the fragments' layout
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float xv[4];
            q_vals(r, ks, hh, xv);
#pragma unroll
            for (int e = 0; e < 4; ++e) amax[r] = fmaxf(amax[r], fabsf(xv[e]));
          }
      float2 qs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sqr[r] = quad_max(amax[r]) / 127.f;
        qs[r] = quant_scale(sqr[r]);
      }
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float xv[4];
            q_vals(r, ks, hh, xv);
            *reinterpret_cast<uint32_t*>(Q8 + (16 * warp + g + 8 * r) * LD + 32 * ks + 16 * hh +
                                         4 * tq) = q4(xv, qs[r]);
          }
      __syncwarp();   // the warp reads only its own rows
    } else {
      float x[2][KS][2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            q_vals(r, ks, hh, x[r][ks][hh]);
#pragma unroll
            for (int e = 0; e < 4; ++e) amax[r] = fmaxf(amax[r], fabsf(x[r][ks][hh][e]));
          }
      float2 qs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sqr[r] = quad_max(amax[r]) / 127.f;
        qs[r] = quant_scale(sqr[r]);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qa[ks][0] = q4(x[0][ks][0], qs[0]);
        qa[ks][1] = q4(x[1][ks][0], qs[1]);
        qa[ks][2] = q4(x[0][ks][1], qs[0]);
        qa[ks][3] = q4(x[1][ks][1], qs[1]);
      }
    }
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // [probe] B5 start
  for (int kt = kr.x; kt < kr.y; ++kt) {
    const int s = (kt - kr.x) & 1, k0 = kt * kI8;
    // [probe] B5 tile start
    if (kt + 1 < kr.y) {
      stage(kt + 1, s ^ 1);
      repro::cp_async_wait_group<1>();
    } else {
      repro::cp_async_wait_group<0>();
    }
    __syncthreads();   // the tile's copies in
    // [probe] B5 tile staged
    const unsigned char* st = smem_i8 + L::STAGES + s * L::STAGE;
    const int8_t* K8 = reinterpret_cast<const int8_t*>(st + L::K8);
    const int8_t* VT = reinterpret_cast<const int8_t*>(st + L::VT);
    const float* sk = reinterpret_cast<const float*>(st + L::SK);
    const float* sv = reinterpret_cast<const float*>(st + L::SV);

    // the masked logits of this warp's rows over the tile, by 32-key chunks
    float x[NT][4];
#pragma unroll
    for (int c = 0; c < TS; ++c) {
      const int key0 = k0 + 32 * c;
      float xc[4][4];
      if (key0 < p.T && tile_visible(r0, 16, key0, 32, p)) {   // warp-uniform
        int si[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) si[j][e] = 0;
        auto qk = [&](int ks, const uint32_t (&qf)[4]) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t kf[4];
            repro::ldmatrix_x4(kf, b8_pair(K8, LD, 32 * c + 16 * jp, 32 * ks, lane));
            repro::mma_s8(si[2 * jp], qf, kf[0], kf[1]);
            repro::mma_s8(si[2 * jp + 1], qf, kf[2], kf[3]);
          }
        };
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if constexpr (kWide) {
            uint32_t qf[4];
            repro::ldmatrix_x4(qf, a8_frag(Q8, LD, 16 * warp, 32 * ks, lane));
            qk(ks, qf);
          } else {
            qk(ks, qa[ks]);
          }
        }
        const bool whole = key0 + 32 <= p.T && (!p.causal || key0 + 31 <= r0) &&
                           (!p.window || r0 + 15 - key0 < p.window);
        if (p.softcap > 0.f) {
          if (whole) fwd_i8_logits<true, false>(xc, si, sk, 32 * c, key0, r0 + g, tq, sqr, p);
          else fwd_i8_logits<true, true>(xc, si, sk, 32 * c, key0, r0 + g, tq, sqr, p);
        } else {
          if (whole) fwd_i8_logits<false, false>(xc, si, sk, 32 * c, key0, r0 + g, tq, sqr, p);
          else fwd_i8_logits<false, true>(xc, si, sk, 32 * c, key0, r0 + g, tq, sqr, p);
        }
      } else {   // no pair of the chunk is visible to these rows: all masked
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xc[j][e] = kNegInf;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * c + j][e] = xc[j][e];
    }
    // [probe] B5 s formed
    // the online softmax of each row over its four lanes; p = exp(s - m_new)
    // unrounded into l, quantized per row over the tile's keys into the A
    // fragments of p v
    float alpha[2], sp[2];
    float2 qs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) mx = fmaxf(mx, x[j][2 * r + e]);
      const float m_new = fmaxf(m[r], quad_max(mx));
      float rs = 0.f, pmax = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = expf(x[j][2 * r + e] - m_new);
          x[j][2 * r + e] = pv;
          rs += pv;
          pmax = fmaxf(pmax, pv);
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      sp[r] = quad_max(pmax) / 127.f;
      qs[r] = quant_scale(sp[r]);
      alpha[r] = expf(m[r] - m_new);
      l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), rs);
      m[r] = m_new;
    }
    uint32_t pa[TS][4];
    bool nz[TS];
#pragma unroll
    for (int c = 0; c < TS; ++c) {
      quant_frag(pa[c], x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3], qs);
      nz[c] = __any_sync(0xffffffffu, (pa[c][0] | pa[c][1] | pa[c][2] | pa[c][3]) != 0u);
    }
    // [probe] B5 p quantized
    // acc = acc alpha + rescale(p8 vT8) (vT8 the B operand, K-major, frag_perm order)
#pragma unroll
    for (int jp = 0; jp < DT / 2; ++jp) {
      int ai[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int c = 0; c < TS; ++c) {
        if (!nz[c]) continue;
        uint32_t vf[4];
        repro::ldmatrix_x4(vf, b8_pair(VT, kI8TLd, 16 * jp, 32 * c, lane));
        repro::mma_s8(ai[0], pa[c], vf[0], vf[1]);
        repro::mma_s8(ai[1], pa[c], vf[2], vf[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * jp + i, r = e >> 1;
          acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], alpha[r]),
                                rescale(ai[i][e], sp[r], sv[8 * j + 2 * tq + (e & 1)]));
        }
    }
    // [probe] B5 products added
    __syncthreads();   // every warp is done with buffer s
    // [probe] B5 tile end
  }
  // [probe] B5 end

  // o = acc / max(l, 1e-30) in o's type, lse = m + log(max(l, 1e-30)), for
  // this thread's rows that lie below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= p.S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = out + (((size_t)b * p.S + row) * p.H + h) * p.d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {   // a thread's two adjacent columns in one store
      const int c = c0 + 8 * j + 2 * tq;
      const float x0 = acc[j][2 * r] / lc, x1 = acc[j][2 * r + 1] / lc;
      if (c + 1 < p.d && p.d % 2 == 0) {
        store_pair(orow + c, x0, x1);
      } else {
        if (c < p.d) orow[c] = from_f32<T>(x0);
        if (c + 1 < p.d) orow[c + 1] = from_f32<T>(x1);
      }
    }
    if (tq == 0 && c0 == 0) lse[((size_t)b * p.H + h) * p.S + row] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// B6, int8 operands, on the s8 tensor cores.
// A block is 4 warps of 16 query rows (a 64-row q tile, one (q tile, head,
// batch) item, q tiles in reverse so the causal rows that see the most keys
// start first) walking the visible 128-key tiles (128 wide: ds k takes its
// scales over the tile's keys).  The tile's k8, v8 and kT8 and their
// scales come from the pre-pass by 16-byte cp.async, double-buffered: the
// next tile's copies fly while the warps multiply.  A warp owns its 16 rows
// across the whole tile: s = q8 k8^T and dp = do8 v8^T by 32-key chunks
// (ldmatrix of the row-quantized bytes, K-contiguous on both sides), ds in
// f32 registers in the accumulator layout (a row's absmax is a quad
// shuffle: no shared memory, no block barrier), quantized straight into
// the A fragments of dq += ds8 kT8 (frag_perm).  Chunks none of the warp's
// rows sees are skipped (their ds is an exact 0).  The f32 steps are
// the dp4a kernel's, in its order: rescale = (float)acc * sa * sb rounded at each
// step, the logit's __fmul_rn, expf, the softcap's tanhf and divide, then
// __fadd_rn into dq tile by tile in increasing key order.
// Registers a thread: ds 64, dq DP / 2, a chunk's s and dp 32; at DP = 64
// ptxas fits them in 168 (no spills on an H100 build), so three blocks, 12
// warps, share an SM: the p/ds step and the quantization are a chain of
// dependent f32 steps per value, and more warps hide it (two blocks an SM,
// 204 registers, ran 136 us at the train shape against 98).
// ---------------------------------------------------------------------------
// B6's shared memory, byte offsets from its base: q8 and do8 of the item,
// then two stages of a key tile (k8, v8, sk, sv; kT8 and skc of the block's
// DC columns)
template <int DP> struct DqI8Smem {
  static constexpr int DC = out_cols<DP>();
  static constexpr size_t Q8 = 0, D8 = smem_piece(kBQ * i8_ld<DP>()), STAGES = 2 * D8;
  static constexpr size_t K8 = 0, V8 = smem_piece(kI8 * i8_ld<DP>()), KT = 2 * V8,
                          SK = KT + smem_piece(DC * kI8TLd), SV = SK + smem_piece(4 * kI8),
                          SKC = SV + smem_piece(4 * kI8), STAGE = SKC + smem_piece(4 * DC),
                          BYTES = STAGES + 2 * STAGE;
};

// B6's p/ds step on one 32-key chunk (keys key0 + 8 j + 2 tq + e, local
// kl0 + ..; rows row0, row0 + 8 at scales sqr, sdr, lse lr, delta dr): ds
// into x, the rows' absmax into amax
template <bool kCap, bool kMask>
__device__ __forceinline__ void dq_i8_grads(float (&x)[4][4], const int (&si)[4][4],
                                            const int (&di)[4][4], const float* sk,
                                            const float* sv, int kl0, int key0, int row0, int tq,
                                            const float (&sqr)[2], const float (&sdr)[2],
                                            const float (&lr)[2], const float (&dr)[2],
                                            float (&amax)[2], const Params& p) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kc = 8 * j + 2 * tq + (e & 1);
      float t = 0.f;
      const float lg = tc_logit<kCap>(rescale(si[j][e], sqr[r], sk[kl0 + kc]), p, t);
      const bool vis = !kMask || visible(row0 + 8 * r, key0 + kc, p);
      const float pij = vis ? expf(lg - lr[r]) : 0.f;
      const float dpv = rescale(di[j][e], sdr[r], sv[kl0 + kc]);
      float g = __fmul_rn(pij, __fsub_rn(dpv, dr[r]));
      if (kCap) g = __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(t, t)));
      x[j][e] = __fmul_rn(g, p.scale);
      amax[r] = fmaxf(amax[r], fabsf(x[j][e]));
    }
}

template <int DP>
__global__ void __launch_bounds__(kI8Threads, DP == 64 ? 3 : 1)
flash_bwd_dq_i8_kernel(const I8Ops o, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq, Params p) {
  // at DP = 256 the block's dq columns are one half, DC = 128, c0..
  // (blockIdx.x's lowest index), with kT8's and skc's rows of them
  constexpr int DC = out_cols<DP>(), NH = DP / DC;
  constexpr int LD = i8_ld<DP>(), KS = DP / 32, DT = DC / 8, NT = kI8 / 8, TS = kI8 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int nq = (p.S + kBQ - 1) / kBQ, hb = p.H * p.B, nT = (p.T + kI8 - 1) / kI8;
  const int item = (int)blockIdx.x / NH, c0 = (int)blockIdx.x % NH * DC;
  const int q0 = (nq - 1 - item / hb) * kBQ;
  const int h = item % hb % p.H, b = item % hb / p.H, kh = h / (p.H / p.K);
  using L = DqI8Smem<DP>;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem_i8 + L::Q8);
  int8_t* D8 = reinterpret_cast<int8_t*>(smem_i8 + L::D8);

  // q8 and do8 of the item, then each visible key tile into buffer (it & 1)
  const int qvalid = min(kBQ, p.S - q0);
  const size_t qrow = (((size_t)b * p.S + q0) * p.H + h) * DP;
  copy_rows8<DP, kI8Threads>(Q8, o.q8 + qrow, (size_t)p.H * DP, kBQ, qvalid, threadIdx.x);
  copy_rows8<DP, kI8Threads>(D8, o.do8 + qrow, (size_t)p.H * DP, kBQ, qvalid, threadIdx.x);
  repro::cp_async_commit();
  const int2 kr = visible_range(nT, [&](int t) { return tile_visible(q0, kBQ, t * kI8, kI8, p); });
  auto stage = [&](int kt, int s) {
    unsigned char* st = smem_i8 + L::STAGES + s * L::STAGE;
    const int k0 = kt * kI8, kvalid = min(kI8, p.T - k0);
    const size_t krow = (((size_t)b * p.T + k0) * p.K + kh) * DP;
    const size_t kcol = ((size_t)b * p.K + kh) * nT + kt;
    copy_rows8<DP, kI8Threads>(reinterpret_cast<int8_t*>(st + L::K8), o.k8 + krow,
                               (size_t)p.K * DP, kI8, kvalid, threadIdx.x);
    copy_rows8<DP, kI8Threads>(reinterpret_cast<int8_t*>(st + L::V8), o.v8 + krow,
                               (size_t)p.K * DP, kI8, kvalid, threadIdx.x);
    copy_tile8<DC, kI8Threads>(reinterpret_cast<int8_t*>(st + L::KT),
                               o.kT8 + (kcol * DP + c0) * kI8, threadIdx.x);
    const size_t ks = ((size_t)b * p.K + kh) * p.T + k0;
    copy_f32s<kI8Threads>(reinterpret_cast<float*>(st + L::SK), o.sk + ks, kI8, kvalid,
                          threadIdx.x);
    copy_f32s<kI8Threads>(reinterpret_cast<float*>(st + L::SV), o.sv + ks, kI8, kvalid,
                          threadIdx.x);
    copy_f32s<kI8Threads>(reinterpret_cast<float*>(st + L::SKC), o.skc + kcol * DP + c0, DC,
                          DC, threadIdx.x);
    repro::cp_async_commit();
  };
  if (kr.x < kr.y) stage(kr.x, 0);

  // this thread's rows are r0 + g + 8 r (r = 0, 1); its columns of each
  // 8-wide n-tile j 8 j + 2 tq + e (e = 0, 1)
  const int r0 = q0 + 16 * warp;
  float sqr[2], sdr[2], lr[2], dr[2], acc[DT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const size_t at = ((size_t)b * p.H + h) * p.S + row;
    const bool in = row < p.S;
    sqr[r] = in ? o.sq[at] : 0.f;
    sdr[r] = in ? o.sdo[at] : 0.f;
    lr[r] = in ? lse[at] : 0.f;
    dr[r] = in ? delta[at] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // [probe] B6 start
  for (int kt = kr.x; kt < kr.y; ++kt) {
    const int s = (kt - kr.x) & 1, k0 = kt * kI8;
    // [probe] B6 tile start
    if (kt + 1 < kr.y) {
      stage(kt + 1, s ^ 1);
      repro::cp_async_wait_group<1>();
    } else {
      repro::cp_async_wait_group<0>();
    }
    __syncthreads();   // the tile's copies (and q8, do8) in
    // [probe] B6 tile staged
    const unsigned char* st = smem_i8 + L::STAGES + s * L::STAGE;
    const int8_t* K8 = reinterpret_cast<const int8_t*>(st + L::K8);
    const int8_t* V8 = reinterpret_cast<const int8_t*>(st + L::V8);
    const int8_t* KT = reinterpret_cast<const int8_t*>(st + L::KT);
    const float* sk = reinterpret_cast<const float*>(st + L::SK);
    const float* sv = reinterpret_cast<const float*>(st + L::SV);
    const float* skc = reinterpret_cast<const float*>(st + L::SKC);

    // ds of this warp's rows over the tile, by 32-key chunks
    float x[NT][4], amax[2] = {0.f, 0.f};
    bool on[TS];
#pragma unroll
    for (int c = 0; c < TS; ++c) {
      const int key0 = k0 + 32 * c;
      on[c] = key0 < p.T && tile_visible(r0, 16, key0, 32, p);   // warp-uniform
      float xc[4][4];
      if (on[c]) {
        int si[4][4], di[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) si[j][e] = di[j][e] = 0;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4], da[4];
          repro::ldmatrix_x4(qa, a8_frag(Q8, LD, 16 * warp, 32 * ks, lane));
          repro::ldmatrix_x4(da, a8_frag(D8, LD, 16 * warp, 32 * ks, lane));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t kf[4], vf[4];
            repro::ldmatrix_x4(kf, b8_pair(K8, LD, 32 * c + 16 * jp, 32 * ks, lane));
            repro::ldmatrix_x4(vf, b8_pair(V8, LD, 32 * c + 16 * jp, 32 * ks, lane));
            repro::mma_s8(si[2 * jp], qa, kf[0], kf[1]);
            repro::mma_s8(si[2 * jp + 1], qa, kf[2], kf[3]);
            repro::mma_s8(di[2 * jp], da, vf[0], vf[1]);
            repro::mma_s8(di[2 * jp + 1], da, vf[2], vf[3]);
          }
        }
        const bool whole = key0 + 32 <= p.T && (!p.causal || key0 + 31 <= r0) &&
                           (!p.window || r0 + 15 - key0 < p.window);
        if (p.softcap > 0.f) {
          if (whole) dq_i8_grads<true, false>(xc, si, di, sk, sv, 32 * c, key0, r0 + g, tq,
                                              sqr, sdr, lr, dr, amax, p);
          else dq_i8_grads<true, true>(xc, si, di, sk, sv, 32 * c, key0, r0 + g, tq, sqr,
                                       sdr, lr, dr, amax, p);
        } else {
          if (whole) dq_i8_grads<false, false>(xc, si, di, sk, sv, 32 * c, key0, r0 + g,
                                               tq, sqr, sdr, lr, dr, amax, p);
          else dq_i8_grads<false, true>(xc, si, di, sk, sv, 32 * c, key0, r0 + g, tq, sqr,
                                        sdr, lr, dr, amax, p);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xc[j][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * c + j][e] = xc[j][e];
    }
    // [probe] B6 ds formed
    // ds quantized per row over the tile's keys into the A fragments
    float sds[2];
    float2 qs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sds[r] = quad_max(amax[r]) / 127.f;
      qs[r] = quant_scale(sds[r]);
    }
    uint32_t dsa[TS][4];
#pragma unroll
    for (int c = 0; c < TS; ++c)
      quant_frag(dsa[c], x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3], qs);
    // [probe] B6 ds quantized
    // dq += rescale(ds8 kT8) (kT8 the B operand, K-major, frag_perm order)
#pragma unroll
    for (int jp = 0; jp < DT / 2; ++jp) {
      int ai[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int c = 0; c < TS; ++c) {
        if (!on[c]) continue;
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, b8_pair(KT, kI8TLd, 16 * jp, 32 * c, lane));
        repro::mma_s8(ai[0], dsa[c], kf[0], kf[1]);
        repro::mma_s8(ai[1], dsa[c], kf[2], kf[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * jp + i;
          acc[j][e] = __fadd_rn(acc[j][e],
                                rescale(ai[i][e], sds[e >> 1], skc[8 * j + 2 * tq + (e & 1)]));
        }
    }
    // [probe] B6 products added
    __syncthreads();   // every warp is done with buffer s
    // [probe] B6 tile end
  }
  // [probe] B6 end

  // this thread's rows of dq that lie below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= p.S) continue;
    float* drow = dq + (((size_t)b * p.S + row) * p.H + h) * p.d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = c0 + 8 * j + 2 * tq;
      if (c + 1 < p.d && p.d % 2 == 0) {
        store_pair(drow + c, acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (c < p.d) drow[c] = acc[j][2 * r];
        if (c + 1 < p.d) drow[c + 1] = acc[j][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B7, int8 operands, on the s8 tensor cores.
// A block owns 32 keys of one kv head and walks the group's G query heads
// and, inside, the visible 128-query tiles in order (128 wide: p^T do and
// ds^T q take their scales over the tile's queries), each tile's q8, do8,
// qT8, doT8, their scales, lse and delta copied from the pre-pass by
// cp.async into one buffer in two groups: the next tile's rows fly during
// this tile's products, its columns during the next p/ds step.  Its 4
// warps pair up: warp w holds keys 16 (w % 2).. and the
// tile's queries 64 (w / 2).., its mate w ^ 2 the same keys and the other
// 64 queries.  A warp forms s^T = k8 q8^T and dp^T = v8 do8^T over its 64
// queries by 32-query chunks (ldmatrix of the row-quantized bytes), and
// p^T and ds^T in f32 registers in the accumulator layout; the mates swap
// each key's maxima through shared memory (a 64-thread named barrier), so
// each quantizes its half at the scales of the whole 128 queries, straight
// into A fragments, and they swap those fragments too.  Then each adds to
// dk and dv over all 128 queries for half of the d columns: rescale(p^T8
// doT8) and rescale(ds^T8 qT8), an n-tile pair at a time.  Halving the
// queries and the columns a warp holds keeps a thread at ~130 registers at
// DP = 64 (p^T, ds^T and the chunk's products 96, dk and dv 32), so three
// blocks, 12 warps, share an SM (55 KB of shared memory each); the blocks
// of the first keys, which the causal mask leaves the most query tiles,
// start first.  As in B6 the per-value chain of the p/ds step and the
// quantization bounds it, not the products.  The f32 steps and their
// order are the dp4a kernel's; dk and dv add over the group's heads
// and the q tiles in increasing order in one block: no atomics, the same
// bits when repeated.
// ---------------------------------------------------------------------------
constexpr int kDkvI8Keys = 32;   // keys a block: 2 groups of 16, each held by a pair of warps

// B7's shared memory, byte offsets from its base: k8 and v8 of the block's
// keys; one query tile (q8, do8, sq, sdo, lse, delta; qT8, doT8, sqc and
// sdoc of the block's DC columns); what the mates swap (each warp's two
// maxima of its 16 keys, and its p^T and ds^T fragments of two chunks, a
// lane's word at a time)
template <int DP> struct DkvI8Smem {
  static constexpr int DC = out_cols<DP>();
  static constexpr size_t K8 = 0, V8 = smem_piece(kDkvI8Keys * i8_ld<DP>()), Q8 = 2 * V8,
                          D8 = Q8 + smem_piece(kI8 * i8_ld<DP>()),
                          QT = D8 + smem_piece(kI8 * i8_ld<DP>()),
                          DT = QT + smem_piece(DC * kI8TLd), SQ = DT + smem_piece(DC * kI8TLd),
                          SDO = SQ + smem_piece(4 * kI8), LS = SDO + smem_piece(4 * kI8),
                          DL = LS + smem_piece(4 * kI8), SQC = DL + smem_piece(4 * kI8),
                          SDOC = SQC + smem_piece(4 * DC), RED = SDOC + smem_piece(4 * DC),
                          FRAG = RED + smem_piece(4 * 4 * 2 * 16),
                          BYTES = FRAG + smem_piece(4 * 4 * 2 * 2 * 4 * 32);
};

// B7's p^T and ds^T of one 32-query chunk (queries q0 + ql, ql = ql0 + 8 j
// + 2 tq + e; keys key + 8 r at scales skr, svr) from its s^T (si) and
// dp^T (di): p^T into xp, ds^T into xd, the keys' maxima into pmax, dmax
template <bool kCap, bool kMask>
__device__ __forceinline__ void dkv_i8_grads(float (&xp)[4][4], float (&xd)[4][4],
                                             const int (&si)[4][4], const int (&di)[4][4],
                                             const float* sq, const float* sdo, const float* ls,
                                             const float* dl, int ql0, int q0, int key, int tq,
                                             const float (&skr)[2], const float (&svr)[2],
                                             float (&pmax)[2], float (&dmax)[2],
                                             const Params& p) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, ql = ql0 + 8 * j + 2 * tq + (e & 1);
      float t = 0.f;
      const float lg = tc_logit<kCap>(rescale(si[j][e], sq[ql], skr[r]), p, t);
      const bool vis = !kMask || (q0 + ql < p.S && visible(q0 + ql, key + 8 * r, p));
      const float pij = vis ? expf(lg - ls[ql]) : 0.f;
      const float dpv = rescale(di[j][e], sdo[ql], svr[r]);
      float gr = __fmul_rn(pij, __fsub_rn(dpv, dl[ql]));
      if (kCap) gr = __fmul_rn(gr, __fsub_rn(1.f, __fmul_rn(t, t)));
      xp[j][e] = pij;
      xd[j][e] = __fmul_rn(gr, p.scale);
      pmax[r] = fmaxf(pmax[r], pij);
      dmax[r] = fmaxf(dmax[r], fabsf(xd[j][e]));
    }
}

// the 64 threads of a pair of warps meet (named barrier `id`, not 0)
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(kI8Threads, DP == 64 ? 3 : DP == 128 ? 2 : 1)
flash_bwd_dkv_i8_kernel(const I8Ops o, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, Params p) {
  // at DP = 256 the block's dk and dv columns are one half, DC = 128, c0..
  // (blockIdx.x's lowest index), with qT8's, doT8's, sqc's and sdoc's rows
  // of them; a warp holds DW of them, from col0 within the block's
  constexpr int DC = out_cols<DP>(), NH = DP / DC;
  constexpr int LD = i8_ld<DP>(), KS = DP / 32, DW = DC / 2, DTW = DW / 8;
  using L = DkvI8Smem<DP>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int kg = warp & 1, qh = warp >> 1, mate = warp ^ 2, col0 = qh * DW;
  // one block a (32-key tile, kv head, batch) item, key tiles slowest: the
  // first key tiles, which the causal mask leaves the most query tiles,
  // start first
  const int item = (int)blockIdx.x / NH, c0 = (int)blockIdx.x % NH * DC;
  const int kb = p.K * p.B, k0 = item / kb * kDkvI8Keys;
  const int kh = item % kb % p.K, b = item % kb / p.K;
  const int G = p.H / p.K, nS = (p.S + kI8 - 1) / kI8, kvalid = min(kDkvI8Keys, p.T - k0);
  extern __shared__ __align__(16) unsigned char smem_i8[];
  auto i8p = [&](size_t at) { return reinterpret_cast<int8_t*>(smem_i8 + at); };
  auto f32p = [&](size_t at) { return reinterpret_cast<float*>(smem_i8 + at); };
  const int8_t *K8 = i8p(L::K8), *V8 = i8p(L::V8), *Q8 = i8p(L::Q8), *D8 = i8p(L::D8);
  const int8_t *QT = i8p(L::QT), *DTt = i8p(L::DT);
  const float *sq = f32p(L::SQ), *sdo = f32p(L::SDO), *ls = f32p(L::LS), *dl = f32p(L::DL);
  const float *sqc = f32p(L::SQC), *sdoc = f32p(L::SDOC);
  float* red = f32p(L::RED);                                     // [warp][2][16]
  uint32_t* frag = reinterpret_cast<uint32_t*>(smem_i8 + L::FRAG);   // [warp][2][2][4][32]

  const size_t krow = (((size_t)b * p.T + k0) * p.K + kh) * DP;
  copy_rows8<DP, kI8Threads>(i8p(L::K8), o.k8 + krow, (size_t)p.K * DP, kDkvI8Keys, kvalid,
                             threadIdx.x);
  copy_rows8<DP, kI8Threads>(i8p(L::V8), o.v8 + krow, (size_t)p.K * DP, kDkvI8Keys, kvalid,
                             threadIdx.x);
  const int2 qr = visible_range(nS, [&](int t) {
    return tile_visible(t * kI8, kI8, k0, kDkvI8Keys, p);
  });
  const int nqt = qr.y - qr.x, n = G * nqt;

  // this thread's keys are key0 + g + 8 r (r = 0, 1), key0 = k0 + 16 kg;
  // its queries of each 8-wide n-tile j of chunk c q0 + 32 c + 8 j + 2 tq +
  // e; its columns of dk and dv col0 + 8 j + 2 tq + e
  const int key0 = k0 + 16 * kg;
  float skr[2], svr[2], dka[DTW][4], dva[DTW][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    const size_t at = ((size_t)b * p.K + kh) * p.T + key;
    skr[r] = key < p.T ? o.sk[at] : 0.f;
    svr[r] = key < p.T ? o.sv[at] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // tile it's copies in two groups: A, the rows (q8, do8 and their
  // scales, lse, delta) that s^T, dp^T and the p/ds step read; B, the
  // columns (qT8, doT8 and their scales) that the products over the tile
  // read.  A of the next tile flies during this tile's products, B of the
  // next during its p/ds step.  (k8 and v8 ride with A of the first.)
  auto copy_rows = [&](int it) {
    const int h = kh * G + it / nqt, q0 = (qr.x + it % nqt) * kI8;
    const int qvalid = min(kI8, p.S - q0), tid = threadIdx.x;
    const size_t qrow = (((size_t)b * p.S + q0) * p.H + h) * DP;
    const size_t qs = ((size_t)b * p.H + h) * p.S + q0;
    copy_rows8<DP, kI8Threads>(i8p(L::Q8), o.q8 + qrow, (size_t)p.H * DP, kI8, qvalid, tid);
    copy_rows8<DP, kI8Threads>(i8p(L::D8), o.do8 + qrow, (size_t)p.H * DP, kI8, qvalid, tid);
    copy_f32s<kI8Threads>(f32p(L::SQ), o.sq + qs, kI8, qvalid, tid);
    copy_f32s<kI8Threads>(f32p(L::SDO), o.sdo + qs, kI8, qvalid, tid);
    copy_f32s<kI8Threads>(f32p(L::LS), lse + qs, kI8, qvalid, tid);
    copy_f32s<kI8Threads>(f32p(L::DL), delta + qs, kI8, qvalid, tid);
    repro::cp_async_commit();
  };
  auto copy_cols = [&](int it) {
    const int h = kh * G + it / nqt, qt = qr.x + it % nqt, tid = threadIdx.x;
    const size_t qcol = ((size_t)b * p.H + h) * nS + qt;
    copy_tile8<DC, kI8Threads>(i8p(L::QT), o.qT8 + (qcol * DP + c0) * kI8, tid);
    copy_tile8<DC, kI8Threads>(i8p(L::DT), o.doT8 + (qcol * DP + c0) * kI8, tid);
    copy_f32s<kI8Threads>(f32p(L::SQC), o.sqc + qcol * DP + c0, DC, DC, tid);
    copy_f32s<kI8Threads>(f32p(L::SDOC), o.sdoc + qcol * DP + c0, DC, DC, tid);
    repro::cp_async_commit();
  };
  if (n > 0) {
    copy_rows(0);
    copy_cols(0);
  }

  // [probe] B7 start
  for (int it = 0; it < n; ++it) {
    const int q0 = (qr.x + it % nqt) * kI8;
    // [probe] B7 tile start
    repro::cp_async_wait_group<1>();   // the rows in (the columns may fly)
    __syncthreads();
    // [probe] B7 tile staged

    // a chunk's s^T or dp^T: A (keys by d) times B (queries by d)
    auto scores = [&](int c, const int8_t* A, const int8_t* Bq, int (&acc)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4];
        repro::ldmatrix_x4(af, a8_frag(A, LD, 16 * kg, 32 * ks, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          repro::ldmatrix_x4(bf, b8_pair(Bq, LD, 32 * c + 16 * jp, 32 * ks, lane));
          repro::mma_s8(acc[2 * jp], af, bf[0], bf[1]);
          repro::mma_s8(acc[2 * jp + 1], af, bf[2], bf[3]);
        }
      }
    };
    // chunk c of the tile holds a pair these keys see
    auto seen = [&](int c) {
      return q0 + 32 * c < p.S && tile_visible(q0 + 32 * c, 32, key0, 16, p);
    };
    // every pair of chunk c visible to these keys
    auto whole = [&](int c) {
      const int qc = q0 + 32 * c;
      return qc + 32 <= p.S && key0 + 16 <= p.T && (!p.causal || key0 + 15 <= qc) &&
             (!p.window || qc + 31 - key0 < p.window);
    };

    // p^T and ds^T over this warp's 64 queries (chunks 2 qh, 2 qh + 1)
    float xp[8][4], xd[8][4], pmax[2] = {0.f, 0.f}, dmax[2] = {0.f, 0.f};
    bool on_own[2], on_mate[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * qh + cc;
      on_own[cc] = seen(c);   // warp-uniform
      on_mate[cc] = seen(2 * (qh ^ 1) + cc);
      float cp[4][4], cd[4][4];
      if (on_own[cc]) {
        int si[4][4], di[4][4];
        scores(c, K8, Q8, si);
        scores(c, V8, D8, di);
        const bool cap = p.softcap > 0.f, wh = whole(c);
        if (cap) {
          if (wh) dkv_i8_grads<true, false>(cp, cd, si, di, sq, sdo, ls, dl, 32 * c, q0,
                                            key0 + g, tq, skr, svr, pmax, dmax, p);
          else dkv_i8_grads<true, true>(cp, cd, si, di, sq, sdo, ls, dl, 32 * c, q0, key0 + g,
                                        tq, skr, svr, pmax, dmax, p);
        } else {
          if (wh) dkv_i8_grads<false, false>(cp, cd, si, di, sq, sdo, ls, dl, 32 * c, q0,
                                             key0 + g, tq, skr, svr, pmax, dmax, p);
          else dkv_i8_grads<false, true>(cp, cd, si, di, sq, sdo, ls, dl, 32 * c, q0, key0 + g,
                                         tq, skr, svr, pmax, dmax, p);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cp[j][e] = cd[j][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xp[4 * cc + j][e] = cp[j][e];
          xd[4 * cc + j][e] = cd[j][e];
        }
    }
    // [probe] B7 ds formed
    // the keys' maxima over all 128 queries: this warp's and its mate's
    float* rw = red + warp * 32;
    const float* rm = red + mate * 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pmax[r] = quad_max(pmax[r]);
      dmax[r] = quad_max(dmax[r]);
      if (tq == 0) {
        rw[g + 8 * r] = pmax[r];
        rw[16 + g + 8 * r] = dmax[r];
      }
    }
    pair_sync(1 + kg);
    float spT[2], sdsT[2];
    float2 qp[2], qd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      spT[r] = fmaxf(pmax[r], rm[g + 8 * r]) / 127.f;
      sdsT[r] = fmaxf(dmax[r], rm[16 + g + 8 * r]) / 127.f;
      qp[r] = quant_scale(spT[r]);
      qd[r] = quant_scale(sdsT[r]);
    }
    // this warp's half quantized into A fragments (chunks 2 qh + cc),
    // shared with the mate through shared memory
    uint32_t pa[2][4], da[2][4], pm[2][4], dm[2][4];
    uint32_t* fw = frag + warp * (2 * 2 * 4 * 32);
    const uint32_t* fm = frag + mate * (2 * 2 * 4 * 32);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      quant_frag(pa[cc], xp[4 * cc], xp[4 * cc + 1], xp[4 * cc + 2], xp[4 * cc + 3], qp);
      quant_frag(da[cc], xd[4 * cc], xd[4 * cc + 1], xd[4 * cc + 2], xd[4 * cc + 3], qd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fw[((0 * 2 + cc) * 4 + i) * 32 + lane] = pa[cc][i];
        fw[((1 * 2 + cc) * 4 + i) * 32 + lane] = da[cc][i];
      }
    }
    repro::cp_async_wait_group<0>();   // the columns in
    __syncthreads();   // the fragments written, the rows read by every warp
    if (it + 1 < n) copy_rows(it + 1);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pm[cc][i] = fm[((0 * 2 + cc) * 4 + i) * 32 + lane];
        dm[cc][i] = fm[((1 * 2 + cc) * 4 + i) * 32 + lane];
      }
    // [probe] B7 ds quantized
    // dv += rescale(p^T8 doT8), dk += rescale(ds^T8 qT8) over this warp's
    // columns and the tile's 128 queries (this warp's chunks, then the
    // mate's: the int32 sums are exact in any order), an n-tile pair at a
    // time
#pragma unroll
    for (int jp = 0; jp < DTW / 2; ++jp) {
      int av[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}}, ak[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      auto add = [&](int c, const uint32_t (&fp)[4], const uint32_t (&fd)[4]) {
        uint32_t f[4];
        repro::ldmatrix_x4(f, b8_pair(DTt, kI8TLd, col0 + 16 * jp, 32 * c, lane));
        repro::mma_s8(av[0], fp, f[0], f[1]);
        repro::mma_s8(av[1], fp, f[2], f[3]);
        repro::ldmatrix_x4(f, b8_pair(QT, kI8TLd, col0 + 16 * jp, 32 * c, lane));
        repro::mma_s8(ak[0], fd, f[0], f[1]);
        repro::mma_s8(ak[1], fd, f[2], f[3]);
      };
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {   // a chunk no key sees holds zeros
        if (on_own[cc]) add(2 * qh + cc, pa[cc], da[cc]);
        if (on_mate[cc]) add(2 * (qh ^ 1) + cc, pm[cc], dm[cc]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * jp + i, col = col0 + 8 * j + 2 * tq + (e & 1);
          dva[j][e] = __fadd_rn(dva[j][e], rescale(av[i][e], spT[e >> 1], sdoc[col]));
          dka[j][e] = __fadd_rn(dka[j][e], rescale(ak[i][e], sdsT[e >> 1], sqc[col]));
        }
    }
    // [probe] B7 products added
    __syncthreads();   // every warp is done with the columns and the swap space
    if (it + 1 < n) copy_cols(it + 1);
    // [probe] B7 tile end
  }
  // [probe] B7 end
  repro::cp_async_wait_all();   // (k8, v8 of a block with no visible tile)

  // this thread's rows of dk and dv among the block's kvalid keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = 16 * kg + g + 8 * r;
    if (kr >= kvalid) continue;
    const size_t off = (((size_t)b * p.T + k0 + kr) * p.K + kh) * p.d;
#pragma unroll
    for (int j = 0; j < DTW; ++j) {
      const int c = c0 + col0 + 8 * j + 2 * tq;
      if (c + 1 < p.d && p.d % 2 == 0) {
        store_pair(dk + off + c, dka[j][2 * r], dka[j][2 * r + 1]);
        store_pair(dv + off + c, dva[j][2 * r], dva[j][2 * r + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < p.d) {
            dk[off + c + e] = dka[j][2 * r + e];
            dv[off + c + e] = dva[j][2 * r + e];
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// opt the kernel in to `smem` bytes of dynamic shared memory, then launch it
template <int Threads = kThreads, typename Kern, typename... Args>
cudaError_t start(Kern kern, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, dim3(Threads), smem, s>>>(args...);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found once through the runtime (so the library
// needs no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// the current device's SM count, read once
cudaError_t sm_count(int* n) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *n = count;
  return cudaSuccess;
}

// Whether the copy engine can stage the rows of q, k, v and do: d values of
// T a multiple of 16 bytes and every tensor 16-byte aligned.  Else the
// tensor-core kernels stage element by element (load_rows_plain).
template <typename T>
bool tma_rows(int d, const void* q, const void* k, const void* v, const void* dout) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  return (d * sizeof(T)) % 16 == 0 && (any & 15) == 0;
}

// The tensor map of a (B, rows, heads, d) tensor of T as 3-D (d, heads, B *
// rows), boxes of `box` rows of one head: a box at (0, head, b * rows + r0)
// is rows r0.. of batch b, dense in shared memory (pitch d); rows past the
// tensor arrive as zeros.
template <typename T>
cudaError_t rows_map(CUtensorMap* map, const void* base, int B, int rows, int heads, int d,
                     int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)B * rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T), (cuuint64_t)d * heads * sizeof(T)};
  const cuuint32_t boxd[3] = {(cuuint32_t)d, 1, (cuuint32_t)box};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, boxd, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int DP>
cudaError_t launch(Which which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse_in, const void* delta,
                   void* out0, void* out1, const Params& p, cudaStream_t s) {
  // DP = 256: B5-B7 in the bf16 mode and B7 in the f32 mode take the
  // output's columns in NH halves (the lowest index of blockIdx.x); the
  // bf16 kernels then round their rows straight from device memory, and
  // p.tma flags rows of whole 16-byte pieces (tma_rows), with no tensor map
  constexpr bool kWide = DP > 128;
  constexpr int NH = col_halves<DP>();
  const int nq = (p.S + kBQ - 1) / kBQ, nk = (p.T + kBK - 1) / kBK;
  const dim3 rows(nq, p.H, p.B), keys(nk * NH, p.K, p.B);
  const bool i8 = p.mode == 2, bf = p.mode == 1;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  const float* ls = static_cast<const float*>(lse_in);
  const float* dl = static_cast<const float*>(delta);
  float* f0 = static_cast<float*>(out0);
  float* f1 = static_cast<float*>(out1);
  if (i8) return cudaErrorInvalidValue;   // B5-B7 int8: repro_flash_*_i8
  if (which == Which::kFwd) {
    T* o = static_cast<T*>(out0);
    if (bf) {
      Params pt = p;
      pt.tma = tma_rows<T>(p.d, q, k, v, q);
      CUtensorMap mq{}, mk{}, mv{};
      if (pt.tma && !kWide) {
        cudaError_t err = rows_map<T>(&mq, q, p.B, p.S, p.H, p.d, kFwdTcBQ);
        if (err == cudaSuccess) err = rows_map<T>(&mk, k, p.B, p.T, p.K, p.d, kFwdBK);
        if (err == cudaSuccess) err = rows_map<T>(&mv, v, p.B, p.T, p.K, p.d, kFwdBK);
        if (err != cudaSuccess) return err;
      }
      // one block an SM, each walking its share of the (q tile, head,
      // batch) items (fwd_item)
      int sms = 0;
      cudaError_t err = sm_count(&sms);
      if (err != cudaSuccess) return err;
      const long long items = (long long)((p.S + kFwdTcBQ - 1) / kFwdTcBQ) * p.H * p.B * NH;
      if (items >= (1ll << 31)) return cudaErrorInvalidValue;
      return start<kFwdTcThreads>(flash_fwd_tc_kernel<T, DP>,
                                  dim3((unsigned)(items < sms ? items : sms)),
                                  fwd_tc_smem_bytes<T, DP>(), s, qq, kk, vv, o, f1, pt, mq, mk,
                                  mv);
    }
    return start(flash_fwd_kernel<T, DP>, rows, fwd_smem_words<DP>() * 4, s,
                 qq, kk, vv, o, f1, p);
  }
  if (which == Which::kDq) {
    if (bf) {
      Params pt = p;
      // only k and v are staged (at DP = 256 q and do are read as rows too)
      pt.tma = kWide ? tma_rows<T>(p.d, q, k, v, dout) : tma_rows<T>(p.d, k, v, k, v);
      CUtensorMap mk{}, mv{};
      if (pt.tma && !kWide) {
        cudaError_t err = rows_map<T>(&mk, k, p.B, p.T, p.K, p.d, kBK);
        if (err == cudaSuccess) err = rows_map<T>(&mv, v, p.B, p.T, p.K, p.d, kBK);
        if (err != cudaSuccess) return err;
      }
      // one block an item (q tile, head, batch), q tiles in reverse
      const long long items = (long long)((p.S + kDqTcBQ - 1) / kDqTcBQ) * p.H * p.B * NH;
      if (items >= (1ll << 31)) return cudaErrorInvalidValue;
      return start<kTcThreads>(flash_bwd_dq_tc_kernel<T, DP>, dim3((unsigned)items),
                               dq_tc_smem_bytes<T, DP>(), s, qq, kk, vv, dd, ls, dl, f0, pt,
                               mk, mv);
    }
    return start(flash_bwd_dq_kernel<T, DP>, rows, dq_smem_words<DP>() * 4, s,
                 qq, kk, vv, dd, ls, dl, f0, p);
  }
  if (bf) {
    Params pt = p;
    pt.tma = tma_rows<T>(p.d, q, k, v, dout);
    CUtensorMap mk{}, mv{}, mq{}, mdo{};
    if (pt.tma && !kWide) {
      cudaError_t err = rows_map<T>(&mk, k, p.B, p.T, p.K, p.d, kBK);
      if (err == cudaSuccess) err = rows_map<T>(&mv, v, p.B, p.T, p.K, p.d, kBK);
      if (err == cudaSuccess) err = rows_map<T>(&mq, q, p.B, p.S, p.H, p.d, kBQ);
      if (err == cudaSuccess) err = rows_map<T>(&mdo, dout, p.B, p.S, p.H, p.d, kBQ);
      if (err != cudaSuccess) return err;
    }
    return start<kTcThreads>(flash_bwd_dkv_tc_kernel<T, DP>, keys, dkv_tc_smem_bytes<T, DP>(),
                             s, qq, kk, vv, dd, ls, dl, f0, f1, pt, mk, mv, mq, mdo);
  }
  return start(flash_bwd_dkv_kernel<T, DP>, keys, dkv_smem_words<DP>() * 4, s,
               qq, kk, vv, dd, ls, dl, f0, f1, p);
}

// The int8 backward: the pre-pass over q, k, v, do into `ops` (the 14
// pointers in I8Ops order), then B6 and B7 on them.
I8Ops i8_ops(void* const* a) {
  return I8Ops{static_cast<int8_t*>(a[0]), static_cast<int8_t*>(a[1]),
               static_cast<int8_t*>(a[2]), static_cast<int8_t*>(a[3]),
               static_cast<int8_t*>(a[4]), static_cast<int8_t*>(a[5]),
               static_cast<int8_t*>(a[6]), static_cast<float*>(a[7]),
               static_cast<float*>(a[8]), static_cast<float*>(a[9]),
               static_cast<float*>(a[10]), static_cast<float*>(a[11]),
               static_cast<float*>(a[12]), static_cast<float*>(a[13])};
}

template <typename T, int DP>
cudaError_t quant_i8(const void* q, const void* k, const void* v, const void* dout,
                     void* const* a, const Params& p, cudaStream_t s) {
  const long long items = 2ll * p.B * p.H * ((p.S + kI8 - 1) / kI8) +
                          2ll * p.B * p.K * ((p.T + kI8 - 1) / kI8);
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  Params pt = p;
  pt.tma = tma_rows<T>(p.d, q, k, v, dout);   // here: rows of whole 16-byte pieces
  return start(flash_quant_i8_kernel<T, DP>, dim3((unsigned)items), quant_i8_smem_bytes<DP>(), s,
               static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
               static_cast<const T*>(dout), i8_ops(a), pt);
}

// The int8 forward: the pre-pass over k and v into `ops` (the 4 pointers
// in FwdI8Ops order), then B5 on them.
FwdI8Ops fwd_i8_ops(void* const* a) {
  return FwdI8Ops{static_cast<int8_t*>(a[0]), static_cast<int8_t*>(a[1]),
                  static_cast<float*>(a[2]), static_cast<float*>(a[3])};
}

template <typename T, int DP>
cudaError_t quant_fwd_i8(const void* k, const void* v, void* const* a, const Params& p,
                         cudaStream_t s) {
  const long long items = 2ll * p.B * p.K * ((p.T + kI8 - 1) / kI8);
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  Params pt = p;
  pt.tma = tma_rows<T>(p.d, k, v, k, v);   // here: rows of whole 16-byte pieces
  return start(flash_quant_fwd_i8_kernel<T, DP>, dim3((unsigned)items),
               quant_i8_smem_bytes<DP>(), s, static_cast<const T*>(k),
               static_cast<const T*>(v), fwd_i8_ops(a), pt);
}

template <typename T, int DP>
cudaError_t fwd_i8(const void* q, void* const* a, void* o, void* lse, const Params& p,
                   cudaStream_t s) {
  // one block an item (64-row q tile, head, batch, and at DP = 256 the
  // column half), q tiles in reverse
  const long long items = (long long)((p.S + kBQ - 1) / kBQ) * p.H * p.B * col_halves<DP>();
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  Params pt = p;
  pt.tma = p.d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;   // q by 4 values
  return start<kI8Threads>(flash_fwd_i8_kernel<T, DP>, dim3((unsigned)items),
                           FwdI8Smem<DP>::BYTES, s, static_cast<const T*>(q), fwd_i8_ops(a),
                           static_cast<T*>(o), static_cast<float*>(lse), pt);
}

template <int DP>
cudaError_t bwd_i8(Which which, void* const* a, const float* lse, const float* delta,
                   float* out0, float* out1, const Params& p, cudaStream_t s) {
  constexpr int NH = col_halves<DP>();   // the column halves at DP = 256
  if (which == Which::kDq) {
    // one block an item (64-row q tile, head, batch), q tiles in reverse
    const long long items = (long long)((p.S + kBQ - 1) / kBQ) * p.H * p.B * NH;
    if (items >= (1ll << 31)) return cudaErrorInvalidValue;
    return start<kI8Threads>(flash_bwd_dq_i8_kernel<DP>, dim3((unsigned)items),
                             DqI8Smem<DP>::BYTES, s, i8_ops(a), lse, delta, out0, p);
  }
  const long long items = (long long)((p.T + kDkvI8Keys - 1) / kDkvI8Keys) * p.K * p.B * NH;
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  return start<kI8Threads>(flash_bwd_dkv_i8_kernel<DP>, dim3((unsigned)items),
                           DkvI8Smem<DP>::BYTES, s, i8_ops(a), lse, delta, out0, out1, p);
}

// fn(type_tag<T>{}) for the storage type `dtype` (0 float32, 1 bfloat16)
template <typename U> struct type_tag { using type = U; };
template <typename Fn>
cudaError_t by_type(int dtype, Fn fn) {
  if (dtype == 0) return fn(type_tag<float>{});
  if (dtype == 1) return fn(type_tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// DP's launches by storage type, as DpLaunches holds them
template <int DP>
cudaError_t flash_dp(Which which, int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta, void* out0,
                     void* out1, const Params& p, cudaStream_t s) {
  return by_type(dtype, [&](auto t) {
    return launch<typename decltype(t)::type, DP>(which, q, k, v, dout, lse, delta, out0,
                                                  out1, p, s);
  });
}
template <int DP>
cudaError_t quant_i8_dp(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, void* const* ops, const Params& p, cudaStream_t s) {
  return by_type(dtype, [&](auto t) {
    return quant_i8<typename decltype(t)::type, DP>(q, k, v, dout, ops, p, s);
  });
}
template <int DP>
cudaError_t quant_fwd_i8_dp(int dtype, const void* k, const void* v, void* const* ops,
                            const Params& p, cudaStream_t s) {
  return by_type(dtype, [&](auto t) {
    return quant_fwd_i8<typename decltype(t)::type, DP>(k, v, ops, p, s);
  });
}
template <int DP>
cudaError_t fwd_i8_dp(int dtype, const void* q, void* const* ops, void* o, void* lse,
                      const Params& p, cudaStream_t s) {
  return by_type(dtype, [&](auto t) {
    return fwd_i8<typename decltype(t)::type, DP>(q, ops, o, lse, p, s);
  });
}
template <int DP> DpLaunches dp_launches() {
  return DpLaunches{flash_dp<DP>, quant_i8_dp<DP>, quant_fwd_i8_dp<DP>, fwd_i8_dp<DP>,
                    bwd_i8<DP>};
}

}  // namespace

#ifndef REPRO_FLASH_DP
#define REPRO_FLASH_DP 64
#define REPRO_FLASH_ENTRY_POINTS   // this translation unit holds the C entry points
#endif
#define REPRO_FLASH_CAT2(a, b) a##b
#define REPRO_FLASH_CAT(a, b) REPRO_FLASH_CAT2(a, b)

// this translation unit's DP
repro_flash::DpLaunches repro_flash::REPRO_FLASH_CAT(launches_dp, REPRO_FLASH_DP)() {
  return dp_launches<REPRO_FLASH_DP>();
}

#ifdef REPRO_FLASH_ENTRY_POINTS
namespace {

// the launches of d's padded width: 64, 128 or 256, the least that holds it
DpLaunches by_dp(int d) {
  return d <= 64 ? repro_flash::launches_dp64()
                 : d <= 128 ? repro_flash::launches_dp128() : repro_flash::launches_dp256();
}

int dispatch(Which which, const void* q, const void* k, const void* v,
             const void* dout, const void* lse_in, const void* delta,
             void* out0, void* out1, int B, int S, int T, int H, int K, int d,
             float scale, int causal, int window, float softcap, int mode,
             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K != 0 || d <= 0 || d > kMaxD ||
      B > 65535 || H > 65535 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, T, H, K, d, scale, causal, window, softcap, mode};
  return static_cast<int>(by_dp(d).flash(which, dtype, q, k, v, dout, lse_in, delta, out0,
                                         out1, p, static_cast<cudaStream_t>(stream)));
}

// the int8 mode's Params, after the checks its entry points share
int i8_params(Params* p, int B, int S, int T, int H, int K, int d, float scale, int causal,
              int window, float softcap) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K != 0 || d <= 0 || d > kMaxD ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  *p = Params{B, S, T, H, K, d, scale, causal, window, softcap, 2};
  return 0;
}

int bwd_i8_dispatch(Which which, void* const* ops, const void* lse, const void* delta,
                    void* out0, void* out1, int B, int S, int T, int H, int K, int d,
                    float scale, int causal, int window, float softcap, void* stream) {
  Params p;
  if (const int err = i8_params(&p, B, S, T, H, K, d, scale, causal, window, softcap)) return err;
  return static_cast<int>(by_dp(d).bwd_i8(
      which, ops, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(out0), static_cast<float*>(out1), p,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and o); mode: 0 = f32
// operands, 1 = bf16 operands, 2 = int8 operands.  Each returns cudaGetLastError() after its
// launch (0 on success).

// B5: o (B, S, H, d) in q's dtype, lse (B, H, S) f32
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int S, int T, int H,
                               int K, int d, float scale, int causal,
                               int window, float softcap, int mode, int dtype,
                               void* stream) {
  return dispatch(Which::kFwd, q, k, v, nullptr, nullptr, nullptr, o, lse, B, S,
                  T, H, K, d, scale, causal, window, softcap, mode, dtype, stream);
}

// B6: dq (B, S, H, d) f32
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int S,
                                  int T, int H, int K, int d, float scale,
                                  int causal, int window, float softcap,
                                  int mode, int dtype, void* stream) {
  return dispatch(Which::kDq, q, k, v, dout, lse, delta, dq, nullptr, B, S, T, H,
                  K, d, scale, causal, window, softcap, mode, dtype, stream);
}

// B5, B6 and B7 take the int8 operand mode (mode 2) only through the entry
// points below, on the pre-passes' operands.

// The int8 forward's pre-pass: k, v (B, T, K, d) of `dtype` into the 4
// buffers of `ops` (FwdI8Ops order, DP = 64, 128 or 256: the least that
// holds d)
extern "C" int repro_flash_quant_fwd_i8(const void* k, const void* v, void* const* ops, int B,
                                        int T, int K, int d, int dtype, void* stream) {
  Params p;
  if (const int err = i8_params(&p, B, 1, T, K, K, d, 1.f, 0, 0, 0.f)) return err;
  return static_cast<int>(
      by_dp(d).quant_fwd_i8(dtype, k, v, ops, p, static_cast<cudaStream_t>(stream)));
}

// B5 in the int8 mode: o (B, S, H, d) in q's dtype, lse (B, H, S) f32, from
// q and the forward pre-pass's `ops`
extern "C" int repro_flash_fwd_i8(const void* q, void* const* ops, void* o, void* lse, int B,
                                  int S, int T, int H, int K, int d, float scale, int causal,
                                  int window, float softcap, int dtype, void* stream) {
  Params p;
  if (const int err = i8_params(&p, B, S, T, H, K, d, scale, causal, window, softcap))
    return err;
  return static_cast<int>(
      by_dp(d).fwd_i8(dtype, q, ops, o, lse, p, static_cast<cudaStream_t>(stream)));
}

// The int8 backward's pre-pass: q, do (B, S, H, d) and k, v (B, T, K, d) of
// `dtype` into the 14 buffers of `ops` (I8Ops order, DP = 64, 128 or 256:
// the least that holds d)
extern "C" int repro_flash_quant_i8(const void* q, const void* k, const void* v,
                                    const void* dout, void* const* ops, int B, int S, int T,
                                    int H, int K, int d, int dtype, void* stream) {
  Params p;
  if (const int err = i8_params(&p, B, S, T, H, K, d, 1.f, 0, 0, 0.f)) return err;
  return static_cast<int>(
      by_dp(d).quant_i8(dtype, q, k, v, dout, ops, p, static_cast<cudaStream_t>(stream)));
}

// B6 in the int8 mode: dq (B, S, H, d) f32 from the pre-pass's `ops`
extern "C" int repro_flash_bwd_dq_i8(void* const* ops, const void* lse, const void* delta,
                                     void* dq, int B, int S, int T, int H, int K, int d,
                                     float scale, int causal, int window, float softcap,
                                     void* stream) {
  return bwd_i8_dispatch(Which::kDq, ops, lse, delta, dq, nullptr, B, S, T, H, K, d, scale,
                         causal, window, softcap, stream);
}

// B7 in the int8 mode: dk, dv (B, T, K, d) f32 from the pre-pass's `ops`
extern "C" int repro_flash_bwd_dkv_i8(void* const* ops, const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int S, int T, int H, int K,
                                      int d, float scale, int causal, int window,
                                      float softcap, void* stream) {
  return bwd_i8_dispatch(Which::kDkv, ops, lse, delta, dk, dv, B, S, T, H, K, d, scale, causal,
                         window, softcap, stream);
}

// B7: dk, dv (B, T, K, d) f32
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, int B,
                                   int S, int T, int H, int K, int d,
                                   float scale, int causal, int window,
                                   float softcap, int mode, int dtype,
                                   void* stream) {
  return dispatch(Which::kDkv, q, k, v, dout, lse, delta, dk, dv, B, S, T, H, K,
                  d, scale, causal, window, softcap, mode, dtype, stream);
}

#endif  // REPRO_FLASH_ENTRY_POINTS
