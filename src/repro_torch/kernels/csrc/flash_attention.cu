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
// kernel_dot(a, b) (src/repro/quant/core.py:48):
//   0 = f32: every tile matmul in f32.
//   1 = bf16: each operand of each tile matmul is rounded to bf16 (nearest
//       even) where kernel_dot rounds it -- q and k^T; the unnormalized p and
//       v; do and v^T; ds and k; p^T and do; ds^T and q -- and the rounded
//       values are multiplied with FFMA in f32.  A product of two bf16
//       values is exact in f32, so this is the bf16 MMA with f32
//       accumulation up to the order of the sums.
//   2 = int8: a is quantized per row and b per column over the contraction
//       axis (scale = absmax / 127 by IEEE division, q = rint(x / max(scale,
//       1e-12)) half to even, clipped to +-127), the int8 products summed
//       exactly in int32 (__dp4a on four packed bytes), then (float)acc *
//       sa * sb in that order (quant/core.py:31-41, :63-67).  q k^T and do
//       v^T take their scales over d; p v and ds k over the tile's keys;
//       p^T do and ds^T q over the tile's queries.  So k, q, do and v are
//       each quantized along two axes inside one kernel.
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
// with bf16 or int8 tensor cores (989 TFLOP/s, 1,979 TOP/s; 0.02-0.03 ms).
// These kernels use neither the tensor cores nor asynchronous copies: they
// are the simple, right first version, FFMA from shared memory in the f32
// and bf16 modes and __dp4a on int8 words from shared memory in the int8
// mode.
//
// Design:
//  - 256 threads as a 16 x 16 grid.  In a score tile of 64 rows by 64 or
//    128 columns (queries by keys; B7 keys by queries) each thread owns rows
//    ty + 16 i and columns tx + 16 j, and a 4 x d/16 block of the output
//    accumulator.  Head dims up to 128
//    are zero-padded to DP = 64 or 128 in shared memory (zeros change no
//    absmax).
//  - Grids: B5 and B6 one block per (64-row q tile, head, batch), looping
//    over the visible k tiles; B7 one block per (64-key k tile, kv head,
//    batch), looping over the G query heads of the group and, inside, the
//    visible q tiles, as the TPU grid (B, K, nk, G, nq) does.  The TPU grid
//    carries the accumulators in VMEM across its sequential axes; here a
//    loop inside the block carries them in registers.
//  - Shared memory, f32 and bf16 modes (f32; rows padded by one word so the
//    column reads of a warp fall in different banks): B5 q, k and v with the
//    p tile over k's space once s is formed, 83 KB at DP = 64 and 165 KB at
//    DP = 128; B6 q, do, k, v and the ds tile, 83 KB; B7 k, v, q, do, p^T and
//    ds^T, 100 KB.  int8 mode: the quantized operands as int8 rows with a
//    one-word pad (a 128 x 128 int8 tile is 16.5 KB) and their scales; no f32
//    copy is kept (rows are quantized by one warp each straight from device
//    memory, columns in two passes over it): B5 32 / 53 KB, B6 46 / 79 KB,
//    B7 64 / 106 KB at DP = 64 / 128.  Most are above 48 KB, so each launch
//    opts in to dynamic shared memory.
//  - Reductions: the row max and row sum of a score tile, and an int8 row's
//    absmax, by warp shuffles; every dot product in a fixed order.  dk and dv
//    are summed over the group's heads and q tiles in a fixed order inside
//    one block: no atomics, and a repeated call gives the same bits.  In the
//    int8 mode the f32 steps before a quantization round as the reference
//    rounds them (__fmul_rn/__fadd_rn: no fused multiply-add).
//  - Any S and T: the ragged last tile is masked (k < T, q < S) and its
//    rows load as zeros, so there is no S % 64 (or 128) rule.
// Later work, not done here: mma.sync or wgmma on the tensor cores (bf16,
// and s8 m16n8k32 for int8), cp.async/TMA double buffering of the next k
// (or q) tile, larger per-thread register tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kBQ = 64;          // query rows per tile (B5, B6; B7 f32/bf16)
constexpr int kBK = 64;          // keys per tile (B7; B6 f32/bf16)
constexpr int kFwdBK = 128;      // B5's keys per tile, every mode
constexpr int kI8 = 128;         // the int8 tile axis that carries scales:
                                 // B6's keys, B7's queries
constexpr int kLTW = kI8 / 4 + 1;   // words in a padded int8 row of kI8 bytes
constexpr int kThreads = 256;    // a 16 x 16 thread grid
constexpr float kNegInf = -2.3819763e38f;   // the reference's NEG_INF

struct Params {
  int B, S, T, H, K, d;
  float scale;
  int causal, window;
  float softcap;
  int mode;   // operand mode: 0 = f32, 1 = bf16, 2 = int8
};

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

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

// rows [row0, row0 + n) of one head (rows `stride` elements apart) into a
// (n, DP) f32 tile with leading dimension ld; zeros beyond `valid` rows and
// beyond d columns; rounded to bf16 in the bf16 mode
template <typename T, int DP>
__device__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                          size_t stride, int row0, int n, int valid, int d,
                          bool bf) {
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    float x = 0.f;
    if (r < valid && c < d) x = rnd(to_f32(src[(size_t)(row0 + r) * stride + c]), bf);
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

// B5: q [BQ][DP + 1], k [FwdBK][DP + 1] (the p tile [BQ][FwdBK + 1] takes its
// place once s is formed), v [FwdBK][DP]
template <int DP> constexpr size_t fwd_smem_words() {
  static_assert(kBQ * (kFwdBK + 1) <= kFwdBK * (DP + 1), "p tile must fit in k's space");
  return (size_t)kBQ * (DP + 1) + (size_t)kFwdBK * (DP + 1) + (size_t)kFwdBK * DP;
}
template <int DP> constexpr size_t dq_smem_words() {
  return 4 * (size_t)kBQ * (DP + 1) + (size_t)kBQ * (kBK + 1);
}
template <int DP> constexpr size_t dkv_smem_words() {
  return 4 * (size_t)kBQ * (DP + 1) + 2 * (size_t)kBK * (kBQ + 1) + 2 * kBQ;
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

// B7's epilogue: this thread's rows of dk and dv among the tile's kvalid keys
template <int NJ>
__device__ __forceinline__ void store_dkv(float* __restrict__ dk, float* __restrict__ dv,
                                          const float (&dk_acc)[4][NJ],
                                          const float (&dv_acc)[4][NJ], int k0, int kvalid,
                                          int kh, int b, int tx, int ty, const Params& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty + 16 * i;
    if (kr >= kvalid) continue;
    const size_t off = (((size_t)b * p.T + k0 + kr) * p.K + kh) * p.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) {
        dk[off + c] = dk_acc[i][j];
        dv[off + c] = dv_acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B5: forward, f32 and bf16 operand modes
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  constexpr int LD = DP + 1, LDP = kFwdBK + 1, NJ = DP / 16, KJ = kFwdBK / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bf = p.mode == 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + kBQ * LD;        // [FwdBK][LD]
  float* ps = ks;                   // [BQ][LDP] unnormalized p, once s is formed
  float* vs = ks + kFwdBK * LD;     // [FwdBK][DP]

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const T* qb = q + ((size_t)b * p.S * p.H + h) * p.d;
  const T* kb = k + ((size_t)b * p.T * p.K + kh) * p.d;
  const T* vb = v + ((size_t)b * p.T * p.K + kh) * p.d;
  load_rows<T, DP>(qs, LD, qb, qstride, q0, kBQ, min(kBQ, p.S - q0), p.d, bf);

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
    load_rows<T, DP>(ks, LD, kb, kstride, k0, kFwdBK, kvalid, p.d, bf);
    load_rows<T, DP>(vs, DP, vb, kstride, k0, kFwdBK, kvalid, p.d, bf);
    __syncthreads();

    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float a[4], kk[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kk[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
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
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = rnd(pv, bf);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), row_sum(rs));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kFwdBK; ++kk) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

  store_out(o, lse, acc, m, l, q0, h, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// B6: dq
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Params p) {
  constexpr int LD = DP + 1, LDP = kBK + 1, NJ = DP / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bf = p.mode == 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* dos = qs + kBQ * LD;       // [BQ][LD]
  float* ks = dos + kBQ * LD;       // [BK][LD]
  float* vs = ks + kBK * LD;        // [BK][LD]
  float* dss = vs + kBK * LD;       // [BQ][LDP]

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d;
  const T* kb = k + ((size_t)b * p.T * p.K + kh) * p.d;
  const T* vb = v + ((size_t)b * p.T * p.K + kh) * p.d;
  const int qvalid = min(kBQ, p.S - q0);
  load_rows<T, DP>(qs, LD, q + qoff, qstride, q0, kBQ, qvalid, p.d, bf);
  load_rows<T, DP>(dos, LD, dout + qoff, qstride, q0, kBQ, qvalid, p.d, bf);
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
    load_rows<T, DP>(ks, LD, kb, kstride, k0, kBK, kvalid, p.d, bf);
    load_rows<T, DP>(vs, LD, vb, kstride, k0, kBK, kvalid, p.d, bf);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float a[4], da[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * LD + c];
        da[i] = dos[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + c];
        vv[j] = vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
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
        dss[(ty + 16 * i) * LDP + tx + 16 * j] = rnd(ds * p.scale, bf);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  store_dq(dq, acc, q0, h, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// B7: dk, dv
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, Params p) {
  constexpr int LD = DP + 1, LQ = kBQ + 1, NJ = DP / 16;
  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bf = p.mode == 1;
  extern __shared__ float smem[];
  float* ks = smem;                 // [BK][LD]
  float* vs = ks + kBK * LD;        // [BK][LD]
  float* qs = vs + kBK * LD;        // [BQ][LD]
  float* dos = qs + kBQ * LD;       // [BQ][LD]
  float* pT = dos + kBQ * LD;       // [BK][LQ] p^T
  float* dsT = pT + kBK * LQ;       // [BK][LQ] ds^T
  float* lse_s = dsT + kBK * LQ;    // [BQ]
  float* delta_s = lse_s + kBQ;     // [BQ]

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t koff = ((size_t)b * p.T * p.K + kh) * p.d;
  const int kvalid = min(kBK, p.T - k0);
  load_rows<T, DP>(ks, LD, k + koff, kstride, k0, kBK, kvalid, p.d, bf);
  load_rows<T, DP>(vs, LD, v + koff, kstride, k0, kBK, kvalid, p.d, bf);

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
      load_rows<T, DP>(qs, LD, q + qoff, qstride, q0, kBQ, qvalid, p.d, bf);
      load_rows<T, DP>(dos, LD, dout + qoff, qstride, q0, kBQ, qvalid, p.d, bf);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        lse_s[r] = r < qvalid ? lse_b[q0 + r] : 0.f;
        delta_s[r] = r < qvalid ? delta_b[q0 + r] : 0.f;
      }
      __syncthreads();

      // scores for query rows tx + 16 j and keys ty + 16 i
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float kk[4], vv[4], a[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = ks[(ty + 16 * i) * LD + c];
          vv[i] = vs[(ty + 16 * i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = qs[(tx + 16 * j) * LD + c];
          da[j] = dos[(tx + 16 * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[j], kk[i], s[i][j]);
            dp[i][j] = fmaf(da[j], vv[i], dp[i][j]);
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
          pT[kr * LQ + r] = rnd(pij, bf);
          dsT[kr * LQ + r] = rnd(ds * p.scale, bf);
        }
      }
      __syncthreads();

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
          dov[j] = dos[r * LD + tx + 16 * j];
          qv[j] = qs[r * LD + tx + 16 * j];
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

  store_dkv(dk, dv, dk_acc, dv_acc, k0, kvalid, kh, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// int8 operand mode: quantization at staging, __dp4a products
// ---------------------------------------------------------------------------

// quantize_int8 of one value at its scale (quant/core.py:31-41): the IEEE
// quotient by max(scale, 1e-12), rounded half to even, clipped to +-127
__device__ __forceinline__ int8_t quant(float x, float scale) {
  const float r = rintf(x / fmaxf(scale, 1e-12f));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// (float)acc * sa * sb, each step rounded on its own (kernel_dot's rescale)
__device__ __forceinline__ float rescale(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows [row0, row0 + n) of one head (rows `stride` elements apart), each
// quantized over its d values into an int8 row of DP bytes at dst + r *
// ldb, its scale into scale[r]; one warp a row, straight from device
// memory.  Rows at or beyond `valid` and columns at or beyond d are zeros.
template <typename T, int DP>
__device__ void quant_rows(int8_t* dst, int ldb, float* scale,
                           const T* __restrict__ src, size_t stride, int row0,
                           int n, int valid, int d) {
  constexpr int E = DP / 32;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += kThreads / 32) {
    float x[E];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = lane + 32 * e;
      x[e] = (r < valid && c < d) ? to_f32(src[(size_t)(row0 + r) * stride + c]) : 0.f;
      amax = fmaxf(amax, fabsf(x[e]));
    }
    const float s = warp_max(amax) / 127.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[r * ldb + lane + 32 * e] = quant(x[e], s);
    if (lane == 0) scale[r] = s;
  }
}

// the DP columns of the kI8 rows [row0, row0 + kI8) of one head, each
// quantized over those rows and stored transposed: column c is the int8 row
// dst + c * ldb (kI8 bytes), its scale scale[c].  Thread t takes column t %
// DP over a 1 / (kThreads / DP) share of the rows, in two passes over device
// memory (absmax, then quantize); `red` holds kThreads partial maxima.
// Rows at or beyond `valid` and columns at or beyond d are zeros.  Holds
// two barriers, so every thread of the block must call it.
template <typename T, int DP>
__device__ void quant_cols(int8_t* dst, int ldb, float* scale, float* red,
                           const T* __restrict__ src, size_t stride, int row0,
                           int valid, int d) {
  constexpr int P = kThreads / DP, RP = kI8 / P;
  const int c = threadIdx.x % DP, part = threadIdx.x / DP;
  const int r0 = part * RP, r1 = min(r0 + RP, valid);
  const bool col = c < d;
  float amax = 0.f;
  if (col)
    for (int r = r0; r < r1; ++r)
      amax = fmaxf(amax, fabsf(to_f32(src[(size_t)(row0 + r) * stride + c])));
  red[threadIdx.x] = amax;
  __syncthreads();
  amax = red[c];
#pragma unroll
  for (int pp = 1; pp < P; ++pp) amax = fmaxf(amax, red[pp * DP + c]);
  __syncthreads();   // red is free for the next call
  const float s = amax / 127.f;
  for (int r = r0; r < r0 + RP; ++r) {
    const float x = (col && r < valid) ? to_f32(src[(size_t)(row0 + r) * stride + c]) : 0.f;
    dst[c * ldb + r] = quant(x, s);
  }
  if (part == 0) scale[c] = s;
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

// words in a padded int8 row of DP bytes
template <int DP> __host__ __device__ constexpr int ldw() { return DP / 4 + 1; }

template <int DP> constexpr size_t fwd_i8_smem_bytes() {
  return smem_piece(4 * kBQ * ldw<DP>()) + smem_piece(4 * kI8 * ldw<DP>())
       + smem_piece(4 * DP * kLTW) + smem_piece(4 * kBQ * kLTW)
       + smem_piece(4 * kBQ) + smem_piece(4 * kI8) + smem_piece(4 * DP)
       + smem_piece(4 * kThreads);
}
template <int DP> constexpr size_t dq_i8_smem_bytes() {
  return 2 * smem_piece(4 * kBQ * ldw<DP>()) + 2 * smem_piece(4 * kI8 * ldw<DP>())
       + smem_piece(4 * DP * kLTW) + smem_piece(4 * kBQ * kLTW)
       + 2 * smem_piece(4 * kBQ) + 2 * smem_piece(4 * kI8) + smem_piece(4 * DP)
       + smem_piece(4 * kThreads);
}
template <int DP> constexpr size_t dkv_i8_smem_bytes() {
  return 2 * smem_piece(4 * kBK * ldw<DP>()) + 2 * smem_piece(4 * kI8 * ldw<DP>())
       + 2 * smem_piece(4 * DP * kLTW) + 2 * smem_piece(4 * kBK * kLTW)
       + 2 * smem_piece(4 * kBK) + 4 * smem_piece(4 * kI8) + 2 * smem_piece(4 * DP)
       + smem_piece(4 * kThreads);
}

// ---------------------------------------------------------------------------
// B5, int8 operands
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_i8_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, Params p) {
  constexpr int LDW = ldw<DP>(), NJ = DP / 16, KJ = kI8 / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  Carve cv{smem_i8};
  int* q8 = cv.take<int>(kBQ * LDW);      // [BQ] rows of DP bytes, per row over d
  int* k8 = cv.take<int>(kI8 * LDW);      // [I8] keys, per key over d
  int* vT8 = cv.take<int>(DP * kLTW);     // [DP] columns of v, over the tile's keys
  int* p8 = cv.take<int>(kBQ * kLTW);     // [BQ] rows of p, over the tile's keys
  float* sq = cv.take<float>(kBQ);
  float* sk = cv.take<float>(kI8);
  float* sv = cv.take<float>(DP);
  float* red = cv.take<float>(kThreads);
  int8_t* p8b = reinterpret_cast<int8_t*>(p8);

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const T* qb = q + ((size_t)b * p.S * p.H + h) * p.d;
  const T* kb = k + ((size_t)b * p.T * p.K + kh) * p.d;
  const T* vb = v + ((size_t)b * p.T * p.K + kh) * p.d;
  quant_rows<T, DP>(reinterpret_cast<int8_t*>(q8), 4 * LDW, sq, qb, qstride, q0, kBQ,
                    min(kBQ, p.S - q0), p.d);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.T + kI8 - 1) / kI8;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kI8;
    if (!tile_visible(q0, kBQ, k0, kI8, p)) continue;   // uniform over the block
    __syncthreads();   // the previous tile's readers of k8, vT8, p8 are done
    const int kvalid = min(kI8, p.T - k0);
    quant_rows<T, DP>(reinterpret_cast<int8_t*>(k8), 4 * LDW, sk, kb, kstride, k0, kI8,
                      kvalid, p.d);
    quant_cols<T, DP>(reinterpret_cast<int8_t*>(vT8), 4 * kLTW, sv, red, vb, kstride, k0,
                      kvalid, p.d);
    __syncthreads();

    int si[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) si[i][j] = 0;
#pragma unroll 4
    for (int w = 0; w < DP / 4; ++w) {
      int a[4], kk[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q8[(ty + 16 * i) * LDW + w];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kk[j] = k8[(tx + 16 * j) * LDW + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) si[i][j] = __dp4a(a[i], kk[j], si[i][j]);
    }

    float alpha[4], sp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      float s[KJ], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = tx + 16 * j;
        float t;
        const float x = logit(rescale(si[i][j], sq[r], sk[key]), p, t);
        s[j] = visible(row, k0 + key, p) ? x : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f, pmax = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[j] = expf(s[j] - m_new);     // the unnormalized p
        rs += s[j];
        pmax = fmaxf(pmax, s[j]);
      }
      sp[i] = row_max(pmax) / 127.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) p8b[r * 4 * kLTW + tx + 16 * j] = quant(s[j], sp[i]);
      alpha[i] = expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), row_sum(rs));
      m[i] = m_new;
    }
    __syncthreads();

    int ai[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ai[i][j] = 0;
#pragma unroll 4
    for (int w = 0; w < kI8 / 4; ++w) {
      int pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p8[(ty + 16 * i) * kLTW + w];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vT8[(tx + 16 * j) * kLTW + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) ai[i][j] = __dp4a(pr[i], vv[j], ai[i][j]);
    }
    // acc * alpha + kernel_dot(p, v), as the reference orders it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], alpha[i]),
                              rescale(ai[i][j], sp[i], sv[tx + 16 * j]));
  }

  store_out(o, lse, acc, m, l, q0, h, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// B6, int8 operands
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_i8_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, Params p) {
  constexpr int LDW = ldw<DP>(), NJ = DP / 16, KJ = kI8 / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  Carve cv{smem_i8};
  int* q8 = cv.take<int>(kBQ * LDW);      // q rows, per row over d
  int* do8 = cv.take<int>(kBQ * LDW);     // do rows, per row over d
  int* k8 = cv.take<int>(kI8 * LDW);      // k rows, per key over d (s)
  int* v8 = cv.take<int>(kI8 * LDW);      // v rows, per key over d (dp)
  int* kT8 = cv.take<int>(DP * kLTW);     // k columns, over the tile's keys (ds k)
  int* ds8 = cv.take<int>(kBQ * kLTW);    // ds rows, over the tile's keys
  float* sq = cv.take<float>(kBQ);
  float* sdo = cv.take<float>(kBQ);
  float* sk = cv.take<float>(kI8);
  float* sv = cv.take<float>(kI8);
  float* skc = cv.take<float>(DP);
  float* red = cv.take<float>(kThreads);
  int8_t* ds8b = reinterpret_cast<int8_t*>(ds8);

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d;
  const T* kb = k + ((size_t)b * p.T * p.K + kh) * p.d;
  const T* vb = v + ((size_t)b * p.T * p.K + kh) * p.d;
  const int qvalid = min(kBQ, p.S - q0);
  quant_rows<T, DP>(reinterpret_cast<int8_t*>(q8), 4 * LDW, sq, q + qoff, qstride, q0,
                    kBQ, qvalid, p.d);
  quant_rows<T, DP>(reinterpret_cast<int8_t*>(do8), 4 * LDW, sdo, dout + qoff, qstride,
                    q0, kBQ, qvalid, p.d);
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

  const int nk = (p.T + kI8 - 1) / kI8;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kI8;
    if (!tile_visible(q0, kBQ, k0, kI8, p)) continue;
    __syncthreads();
    const int kvalid = min(kI8, p.T - k0);
    quant_rows<T, DP>(reinterpret_cast<int8_t*>(k8), 4 * LDW, sk, kb, kstride, k0, kI8,
                      kvalid, p.d);
    quant_rows<T, DP>(reinterpret_cast<int8_t*>(v8), 4 * LDW, sv, vb, kstride, k0, kI8,
                      kvalid, p.d);
    quant_cols<T, DP>(reinterpret_cast<int8_t*>(kT8), 4 * kLTW, skc, red, kb, kstride, k0,
                      kvalid, p.d);
    __syncthreads();

    int si[4][KJ], dpi[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) si[i][j] = dpi[i][j] = 0;
#pragma unroll 2
    for (int w = 0; w < DP / 4; ++w) {
      int a[4], da[4], kk[KJ], vv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q8[(ty + 16 * i) * LDW + w];
        da[i] = do8[(ty + 16 * i) * LDW + w];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kk[j] = k8[(tx + 16 * j) * LDW + w];
        vv[j] = v8[(tx + 16 * j) * LDW + w];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          si[i][j] = __dp4a(a[i], kk[j], si[i][j]);
          dpi[i][j] = __dp4a(da[i], vv[j], dpi[i][j]);
        }
    }

    float sds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      float ds[KJ], amax = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = tx + 16 * j;
        float t;
        const float x = logit(rescale(si[i][j], sq[r], sk[key]), p, t);
        const float pij = visible(row, k0 + key, p) ? expf(x - lse_r[i]) : 0.f;
        const float dp = rescale(dpi[i][j], sdo[r], sv[key]);
        float g = __fmul_rn(pij, __fsub_rn(dp, delta_r[i]));
        if (p.softcap > 0.f) g = __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(t, t)));
        ds[j] = __fmul_rn(g, p.scale);
        amax = fmaxf(amax, fabsf(ds[j]));
      }
      sds[i] = row_max(amax) / 127.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) ds8b[r * 4 * kLTW + tx + 16 * j] = quant(ds[j], sds[i]);
    }
    __syncthreads();

    int ai[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ai[i][j] = 0;
#pragma unroll 4
    for (int w = 0; w < kI8 / 4; ++w) {
      int dv[4], kc[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = ds8[(ty + 16 * i) * kLTW + w];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kc[j] = kT8[(tx + 16 * j) * kLTW + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) ai[i][j] = __dp4a(dv[i], kc[j], ai[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], rescale(ai[i][j], sds[i], skc[tx + 16 * j]));
  }

  store_dq(dq, acc, q0, h, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// B7, int8 operands
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_i8_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, Params p) {
  constexpr int LDW = ldw<DP>(), NJ = DP / 16, QJ = kI8 / 16;
  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  Carve cv{smem_i8};
  int* k8 = cv.take<int>(kBK * LDW);      // k rows, per key over d
  int* v8 = cv.take<int>(kBK * LDW);      // v rows, per key over d
  int* q8 = cv.take<int>(kI8 * LDW);      // q rows, per query over d
  int* do8 = cv.take<int>(kI8 * LDW);     // do rows, per query over d
  int* qT8 = cv.take<int>(DP * kLTW);     // q columns, over the tile's queries
  int* doT8 = cv.take<int>(DP * kLTW);    // do columns, over the tile's queries
  int* pT8 = cv.take<int>(kBK * kLTW);    // p^T rows (keys), over the tile's queries
  int* dsT8 = cv.take<int>(kBK * kLTW);   // ds^T rows (keys), over the tile's queries
  float* sk = cv.take<float>(kBK);
  float* sv = cv.take<float>(kBK);
  float* sq = cv.take<float>(kI8);
  float* sdo = cv.take<float>(kI8);
  float* sqc = cv.take<float>(DP);
  float* sdoc = cv.take<float>(DP);
  float* lse_s = cv.take<float>(kI8);
  float* delta_s = cv.take<float>(kI8);
  float* red = cv.take<float>(kThreads);
  int8_t* pT8b = reinterpret_cast<int8_t*>(pT8);
  int8_t* dsT8b = reinterpret_cast<int8_t*>(dsT8);

  const size_t qstride = (size_t)p.H * p.d, kstride = (size_t)p.K * p.d;
  const size_t koff = ((size_t)b * p.T * p.K + kh) * p.d;
  const int kvalid = min(kBK, p.T - k0);
  quant_rows<T, DP>(reinterpret_cast<int8_t*>(k8), 4 * LDW, sk, k + koff, kstride, k0,
                    kBK, kvalid, p.d);
  quant_rows<T, DP>(reinterpret_cast<int8_t*>(v8), 4 * LDW, sv, v + koff, kstride, k0,
                    kBK, kvalid, p.d);

  // this thread's keys are ty + 16 i (rows of p^T), its d columns tx + 16 j
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (p.S + kI8 - 1) / kI8;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t qoff = ((size_t)b * p.S * p.H + h) * p.d;
    const float* lse_b = lse + ((size_t)b * p.H + h) * p.S;
    const float* delta_b = delta + ((size_t)b * p.H + h) * p.S;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kI8;
      if (!tile_visible(q0, kI8, k0, kBK, p)) continue;
      __syncthreads();   // the previous tile's readers are done
      const int qvalid = min(kI8, p.S - q0);
      quant_rows<T, DP>(reinterpret_cast<int8_t*>(q8), 4 * LDW, sq, q + qoff, qstride,
                        q0, kI8, qvalid, p.d);
      quant_rows<T, DP>(reinterpret_cast<int8_t*>(do8), 4 * LDW, sdo, dout + qoff,
                        qstride, q0, kI8, qvalid, p.d);
      quant_cols<T, DP>(reinterpret_cast<int8_t*>(qT8), 4 * kLTW, sqc, red, q + qoff,
                        qstride, q0, qvalid, p.d);
      quant_cols<T, DP>(reinterpret_cast<int8_t*>(doT8), 4 * kLTW, sdoc, red, dout + qoff,
                        qstride, q0, qvalid, p.d);
      for (int r = threadIdx.x; r < kI8; r += kThreads) {
        lse_s[r] = r < qvalid ? lse_b[q0 + r] : 0.f;
        delta_s[r] = r < qvalid ? delta_b[q0 + r] : 0.f;
      }
      __syncthreads();

      // scores for keys ty + 16 i and query rows tx + 16 j
      int si[4][QJ], dpi[4][QJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) si[i][j] = dpi[i][j] = 0;
#pragma unroll 2
      for (int w = 0; w < DP / 4; ++w) {
        int kk[4], vv[4], a[QJ], da[QJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = k8[(ty + 16 * i) * LDW + w];
          vv[i] = v8[(ty + 16 * i) * LDW + w];
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          a[j] = q8[(tx + 16 * j) * LDW + w];
          da[j] = do8[(tx + 16 * j) * LDW + w];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j) {
            si[i][j] = __dp4a(a[j], kk[i], si[i][j]);
            dpi[i][j] = __dp4a(da[j], vv[i], dpi[i][j]);
          }
      }

      float spT[4], sdsT[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
        float pv[QJ], ds[QJ], pmax = 0.f, dmax = 0.f;
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const int r = tx + 16 * j;
          const int row = q0 + r;
          float t;
          const float x = logit(rescale(si[i][j], sq[r], sk[kr]), p, t);
          const bool vis = row < p.S && visible(row, k0 + kr, p);
          pv[j] = vis ? expf(x - lse_s[r]) : 0.f;
          const float dp = rescale(dpi[i][j], sdo[r], sv[kr]);
          float g2 = __fmul_rn(pv[j], __fsub_rn(dp, delta_s[r]));
          if (p.softcap > 0.f) g2 = __fmul_rn(g2, __fsub_rn(1.f, __fmul_rn(t, t)));
          ds[j] = __fmul_rn(g2, p.scale);
          pmax = fmaxf(pmax, pv[j]);
          dmax = fmaxf(dmax, fabsf(ds[j]));
        }
        spT[i] = row_max(pmax) / 127.f;
        sdsT[i] = row_max(dmax) / 127.f;
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          pT8b[kr * 4 * kLTW + tx + 16 * j] = quant(pv[j], spT[i]);
          dsT8b[kr * 4 * kLTW + tx + 16 * j] = quant(ds[j], sdsT[i]);
        }
      }
      __syncthreads();

      int av[4][NJ], ak[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) av[i][j] = ak[i][j] = 0;
#pragma unroll 2
      for (int w = 0; w < kI8 / 4; ++w) {
        int pw[4], dw[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pw[i] = pT8[(ty + 16 * i) * kLTW + w];
          dw[i] = dsT8[(ty + 16 * i) * kLTW + w];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = doT8[(tx + 16 * j) * kLTW + w];
          qv[j] = qT8[(tx + 16 * j) * kLTW + w];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            av[i][j] = __dp4a(pw[i], dov[j], av[i][j]);
            ak[i][j] = __dp4a(dw[i], qv[j], ak[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          dv_acc[i][j] = __fadd_rn(dv_acc[i][j], rescale(av[i][j], spT[i], sdoc[c]));
          dk_acc[i][j] = __fadd_rn(dk_acc[i][j], rescale(ak[i][j], sdsT[i], sqc[c]));
        }
    }
  }

  store_dkv(dk, dv, dk_acc, dv_acc, k0, kvalid, kh, b, tx, ty, p);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum class Which { kFwd, kDq, kDkv };

// opt the kernel in to `smem` bytes of dynamic shared memory, then launch it
template <typename Kern, typename... Args>
cudaError_t start(Kern kern, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, dim3(kThreads), smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch(Which which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse_in, const void* delta,
                   void* out0, void* out1, const Params& p, cudaStream_t s) {
  const int nq = (p.S + kBQ - 1) / kBQ, nk = (p.T + kBK - 1) / kBK;
  const dim3 rows(nq, p.H, p.B), keys(nk, p.K, p.B);
  const bool i8 = p.mode == 2;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  const float* ls = static_cast<const float*>(lse_in);
  const float* dl = static_cast<const float*>(delta);
  float* f0 = static_cast<float*>(out0);
  float* f1 = static_cast<float*>(out1);
  if (which == Which::kFwd) {
    T* o = static_cast<T*>(out0);
    if (i8) return start(flash_fwd_i8_kernel<T, DP>, rows, fwd_i8_smem_bytes<DP>(), s,
                         qq, kk, vv, o, f1, p);
    return start(flash_fwd_kernel<T, DP>, rows, fwd_smem_words<DP>() * 4, s,
                 qq, kk, vv, o, f1, p);
  }
  if (which == Which::kDq) {
    if (i8) return start(flash_bwd_dq_i8_kernel<T, DP>, rows, dq_i8_smem_bytes<DP>(), s,
                         qq, kk, vv, dd, ls, dl, f0, p);
    return start(flash_bwd_dq_kernel<T, DP>, rows, dq_smem_words<DP>() * 4, s,
                 qq, kk, vv, dd, ls, dl, f0, p);
  }
  if (i8) return start(flash_bwd_dkv_i8_kernel<T, DP>, keys, dkv_i8_smem_bytes<DP>(), s,
                       qq, kk, vv, dd, ls, dl, f0, f1, p);
  return start(flash_bwd_dkv_kernel<T, DP>, keys, dkv_smem_words<DP>() * 4, s,
               qq, kk, vv, dd, ls, dl, f0, f1, p);
}

template <typename T>
cudaError_t launch_d(Which which, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse_in, const void* delta,
                     void* out0, void* out1, const Params& p, cudaStream_t s) {
  if (p.d <= 64) return launch<T, 64>(which, q, k, v, dout, lse_in, delta, out0, out1, p, s);
  return launch<T, 128>(which, q, k, v, dout, lse_in, delta, out0, out1, p, s);
}

int dispatch(Which which, const void* q, const void* k, const void* v,
             const void* dout, const void* lse_in, const void* delta,
             void* out0, void* out1, int B, int S, int T, int H, int K, int d,
             float scale, int causal, int window, float softcap, int mode,
             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K != 0 || d <= 0 || d > 128 ||
      B > 65535 || H > 65535 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, T, H, K, d, scale, causal, window, softcap, mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(which, q, k, v, dout, lse_in, delta, out0, out1, p, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(which, q, k, v, dout, lse_in, delta, out0, out1, p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
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
