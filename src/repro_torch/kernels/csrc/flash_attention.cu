// Flash attention for Hopper (sm_90a): forward (B5), dq (B6) and dk/dv (B7).
//
// B5 replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (:77, pallas_call at :250), B6 _flash_bwd_dq_kernel (:158,
// pallas_call at :288) and B7 _flash_bwd_dkv_kernel (:194, pallas_call at
// :319), in their f32 and bf16 operand modes:
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
// Operand modes (argument `mode`): 0 = f32, every tile matmul in f32;
// 1 = bf16: each operand of each tile matmul is rounded to bf16 (nearest
// even) where the reference's kernel_dot rounds it -- q and k^T; the
// unnormalized p and v; do and v^T; ds and k; p^T and do; ds^T and q -- and
// the rounded values are multiplied with FFMA in f32.  A product of two bf16
// values is exact in f32, so this is the bf16 MMA with f32 accumulation up
// to the order of the sums.  Storage: q, k, v, do in f32 or bf16 (all one
// type); o in q's type; lse, dq, dk, dv in f32.
//
// What bounds them on the H100: at mup-gpt's training shape (8 x 512 x 16
// heads of 64, causal) the tile matmuls are 4, 6 and 8 d flops per visible
// (query, key) pair (4.3, 6.5 and 8.6 GFLOP) over 67-101 MB of reads and
// writes: bound by operations in f32 (67 TFLOP/s, 0.06-0.13 ms) and by bytes
// with bf16 tensor cores (989 TFLOP/s, 0.02-0.03 ms).  These kernels use
// neither the tensor cores nor asynchronous copies: they are the simple,
// right first version, and run FFMA from shared memory.
//
// Design:
//  - Tiles of 64 query rows by 64 keys; 256 threads as a 16 x 16 grid, each
//    owning a 4 x 4 block of the score tile (rows ty + 16 i, columns
//    tx + 16 j) and a 4 x d/16 block of the output accumulator.  Head dims
//    up to 128 are zero-padded to DP = 64 or 128 in shared memory.
//  - Grids: B5 and B6 one block per (q tile, head, batch), looping over the
//    visible k tiles; B7 one block per (k tile, kv head, batch), looping
//    over the G query heads of the group and, inside, the visible q tiles,
//    as the TPU grid (B, K, nk, G, nq) does.  The TPU grid carries the
//    accumulators in VMEM across its sequential axes; here a loop inside
//    the block carries them in registers.
//  - Shared memory (f32; rows padded by one word so the column reads of a
//    warp fall in different banks): B5 q, k, v and the p tile, 66 KB at
//    DP = 64; B6 q, do, k, v and the ds tile, 83 KB; B7 k, v, q, do, p^T
//    and ds^T, 100 KB.  Above 48 KB, so each launch opts in to dynamic
//    shared memory.
//  - Reductions: the row max and row sum of a score tile by warp shuffles
//    over the 16 threads of a row; every dot product in a fixed order over
//    d (or over the tile's keys or queries).  dk and dv are summed over the
//    group's heads and q tiles in a fixed order inside one block: no
//    atomics, and a repeated call gives the same bits.
//  - Any S and T: the ragged last tile is masked (k < T, q < S) and its
//    rows load as zeros, so there is no S % 64 rule.
// Later work, not done here: mma.sync or wgmma on the tensor cores for the
// bf16 mode, cp.async/TMA double buffering of the next k (or q) tile, larger
// per-thread register tiles, and the int8 operand mode (s8 MMA with the
// reference's per-tile scales over its 128-wide tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 thread grid
constexpr float kNegInf = -2.3819763e38f;   // the reference's NEG_INF

struct Params {
  int B, S, T, H, K, d;
  float scale;
  int causal, window;
  float softcap;
  int bf16;   // operand mode: 0 = f32, 1 = bf16
};

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// _block_visible: could any (query, key) pair of the tile pair be visible?
__device__ __forceinline__ bool tile_visible(int q0, int k0, const Params& p) {
  bool needed = true;
  if (p.causal) needed = k0 <= q0 + kBQ - 1;
  if (p.window) needed = needed && (k0 + kBK - 1 >= q0 - p.window + 1);
  return needed;
}

// _tile_mask for one pair
__device__ __forceinline__ bool visible(int qi, int ki, const Params& p) {
  bool m = ki < p.T;
  if (p.causal) m = m && ki <= qi;
  if (p.window) m = m && (qi - ki) < p.window;
  return m;
}

// the logit before the mask, and the tanh of the softcap (0 without one)
__device__ __forceinline__ float logit(float dot, const Params& p, float& t) {
  float x = dot * p.scale;
  t = 0.f;
  if (p.softcap > 0.f) {
    t = tanhf(x / p.softcap);
    x = p.softcap * t;
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

template <int DP> constexpr size_t fwd_smem_words() {
  return 2 * (size_t)kBQ * (DP + 1) + (size_t)kBK * DP + (size_t)kBQ * (kBK + 1);
}
template <int DP> constexpr size_t dq_smem_words() {
  return 4 * (size_t)kBQ * (DP + 1) + (size_t)kBQ * (kBK + 1);
}
template <int DP> constexpr size_t dkv_smem_words() {
  return 4 * (size_t)kBQ * (DP + 1) + 2 * (size_t)kBK * (kBQ + 1) + 2 * kBQ;
}

// ---------------------------------------------------------------------------
// B5: forward
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  constexpr int LD = DP + 1, LDP = kBK + 1, NJ = DP / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bf = p.bf16;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + kBQ * LD;        // [BK][LD]
  float* vs = ks + kBK * LD;        // [BK][DP]
  float* ps = vs + kBK * DP;        // [BQ][LDP] unnormalized p

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

  const int nk = (p.T + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_visible(q0, k0, p)) continue;   // uniform over the block
    __syncthreads();   // the previous tile's readers of ks, vs, ps are done
    const int kvalid = min(kBK, p.T - k0);
    load_rows<T, DP>(ks, LD, kb, kstride, k0, kBK, kvalid, p.d, bf);
    load_rows<T, DP>(vs, DP, vb, kstride, k0, kBK, kvalid, p.d, bf);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        const float x = logit(s[i][j], p, t);
        s[i][j] = visible(row, k0 + tx + 16 * j, p) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        rs += pv;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = rnd(pv, bf);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
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
  const bool bf = p.bf16;
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
    if (!tile_visible(q0, k0, p)) continue;
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
  const bool bf = p.bf16;
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
      if (!tile_visible(q0, k0, p)) continue;
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
// launches
// ---------------------------------------------------------------------------

enum class Which { kFwd, kDq, kDkv };

template <typename T, int DP>
cudaError_t launch(Which which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse_in, const void* delta,
                   void* out0, void* out1, const Params& p, cudaStream_t s) {
  const dim3 block(kThreads);
  const int nq = (p.S + kBQ - 1) / kBQ, nk = (p.T + kBK - 1) / kBK;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  cudaError_t err;
  if (which == Which::kFwd) {
    const size_t smem = fwd_smem_words<DP>() * 4;
    auto kern = flash_fwd_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(nq, p.H, p.B), block, smem, s>>>(
        qq, kk, vv, static_cast<T*>(out0), static_cast<float*>(out1), p);
  } else if (which == Which::kDq) {
    const size_t smem = dq_smem_words<DP>() * 4;
    auto kern = flash_bwd_dq_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(nq, p.H, p.B), block, smem, s>>>(
        qq, kk, vv, static_cast<const T*>(dout), static_cast<const float*>(lse_in),
        static_cast<const float*>(delta), static_cast<float*>(out0), p);
  } else {
    const size_t smem = dkv_smem_words<DP>() * 4;
    auto kern = flash_bwd_dkv_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(nk, p.K, p.B), block, smem, s>>>(
        qq, kk, vv, static_cast<const T*>(dout), static_cast<const float*>(lse_in),
        static_cast<const float*>(delta), static_cast<float*>(out0),
        static_cast<float*>(out1), p);
  }
  return cudaGetLastError();
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
      B > 65535 || H > 65535 || (mode != 0 && mode != 1))
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
// operands, 1 = bf16 operands.  Each returns cudaGetLastError() after its
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
