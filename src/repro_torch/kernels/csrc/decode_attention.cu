// Paged flash decode for Hopper (sm_90a): B8, one query per slot, and B9,
// a chunk of T queries per slot.  Two separate __global__ functions, so the
// launch counts say which path ran.
//
// Pools are float32, bfloat16 or int8 (TKV).  Int8 pools come with (N, K)
// float32 scales, one per page per kv head (the reference's kv_quant mode,
// decode_attention.py:79-83 for B8 and :158-160 for B9): the kernel
// dequantizes as it stages a page into shared memory, float(int8) * scale,
// in the reference's order, and everything after staging (masks, online
// softmax, exact zeros for rows at -1) is the float path's.  Each block
// reads the page's two scales once per page (one broadcast load per warp).
// The wrapper counts int8 launches apart, so a launch count says which
// pool type ran.  Later work, not done here: int8 dp4a/MMA for q . k with
// the scale applied to the logits, which would read 1 byte per element
// straight from the pool.
//
// ---------------------------------------------------------------------------
// B8: flash_decode_kernel
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_kernel (pallas_call at decode_attention.py:264, reached through
// flash_decode() :193), float32, bfloat16 and int8 pools:
//     out[b, h] = sum_t softmax_t(mask(softcap(scale * q[b, h] . k_t))) v_t
// over the tokens t stored in slot b's pages, for kv head h / G.
//
// What bounds it on the H100: device-memory bandwidth.  Each live K/V byte
// feeds 2 * G flops (the G query heads of one kv head share it): about 1.5
// flop/byte at G = 3 in float32 (6 over int8 pages), far below the ~295
// flop/byte ridge.  The floor is the live K/V bytes (plus positions, the
// int8 scales, q and out) over 3.35 TB/s.
//
// What the design does about it:
//  - One block per (slot, kv head).  The G query heads of a GQA group share
//    every K/V page load, as the TPU kernel's GQA group per program does.
//  - The block walks only the slot's live pages, n_live = min(C, q_pos/P+1),
//    and none for q_pos < 0.  The TPU grid visits all C pages and skips the
//    dead ones; here dead pages cost nothing at all.
//  - Page ids are read from the table and clamped to [0, N-1], as the TPU
//    wrapper does (decode_attention.py:225).
//  - A page's K/V rows for this kv head are staged in shared memory with
//    coalesced loads (consecutive threads, consecutive d), converted to f32.
//    K rows are padded by one float so that the per-token dot products of a
//    warp fall into different banks.
//  - The online softmax (m, l, acc) lives in shared memory across pages, in
//    f32 throughout, with p = 0 written explicitly on masked entries and a
//    guarded final divide, so a fully-masked row gives exact zeros.
// Later work, not done here: split-KV across blocks (B * K blocks underfill
// 132 SMs at small batch), and cp.async/TMA double buffering of the next
// page behind the current page's math.
//
// ---------------------------------------------------------------------------
// B9: flash_decode_multi_kernel
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_multi_kernel (pallas_call at decode_attention.py:345, reached
// through flash_decode_multi() :273), float32, bfloat16 and int8 pools:
//     out[b, t, h] = sum_s softmax_s(mask_t(softcap(scale * q[b, t, h] . k_s))) v_s
// with mask_t(s) = pos_s >= 0 && pos_s <= q_pos[b, t] (&& q_pos - pos_s <
// window): the per-row position mask gives the history and, since the
// engine writes the chunk into the pages before attending, causality
// inside the chunk.  Chunked prefill, prefix-cache suffixes and
// speculative verify run it.
//
// What bounds it on the H100: at chunk sizes, the float32 operations.  A
// live token's K and V rows (8 d bytes in f32) feed 4 d flops for each of
// the T x G rows: T * G / 2 flop per byte, 96 at T = 64, G = 3, above the
// f32 ridge of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s); at T = 1 it is
// B8's bandwidth bound.
//
// What the design does about it:
//  - The TPU program holds all T x G rows of one (slot, kv head) in VMEM;
//    at a 256-token chunk with G = 3, d = 64 the accumulators alone are
//    196 KB, which no block holds.  So one block owns (slot, kv head, tile
//    of tq queries): tq x G rows whose (m, l, acc) and q live in shared
//    memory, and each live page is staged in shared memory once per block
//    (coalesced, converted to f32, K rows padded by one float against bank
//    conflicts), as in B8.
//  - tq is chosen on the host (multi_rows): the most rows that fit the
//    48 KB of shared memory, at most kMultiRows, then halved while the grid
//    is smaller than the card's 132 SMs: at the engine's chunk (one slot,
//    3 kv heads) the per-page latency, not the arithmetic, sets the time,
//    so more blocks each walking the pages beat fewer sharing them.
//  - Live pages: min(C, max_q_pos // P + 1) over the tile's rows, none when
//    every row is at -1.  The reference bounds by the chunk's largest
//    q_pos; a page past a row's own position is fully masked for that row
//    and leaves its (m, l, acc) unchanged, so the numbers are the same.
//  - Rows at q_pos -1 (and the rows past T in the last tile, which are
//    never stored) see no entry: p is written as 0 on masked entries and
//    the final divide is guarded, so they give exact zeros, as the
//    reference's _finalize does.
//  - Page ids are clamped to [0, N-1], as the reference wrapper does.
//    Pages shared between slots by the prefix cache are only read here.
// Later work, not done here: tensor-core MMA for the (tq G x d) . (d x P)
// products, split-KV, cp.async/TMA double buffering.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

// A pool element as f32: int8 bytes times their page's scale (the
// reference's k.astype(f32) * ks), other types as they are.
template <typename TKV>
__device__ __forceinline__ float staged(TKV v, float) { return to_f32(v); }
template <>
__device__ __forceinline__ float staged<int8_t>(int8_t v, float s) { return to_f32(v) * s; }

// The page's k and v scales for kv head kh (1 for pools without scales).
template <typename TKV>
__device__ __forceinline__ float2 page_scales(const float* k_scale, const float* v_scale,
                                              int page, int K, int kh) {
  if constexpr (std::is_same<TKV, int8_t>::value) {
    const size_t i = (size_t)page * K + kh;
    return make_float2(k_scale[i], v_scale[i]);
  } else {
    return make_float2(1.f, 1.f);
  }
}

constexpr int kThreads = 128;
constexpr float kNegInf = -2.3819763e38f;  // the reference's masking constant
constexpr size_t kMaxSmem = 48 * 1024;

// Shared memory layout, in 4-byte words.
__host__ __device__ inline size_t smem_words(int G, int d, int P) {
  return (size_t)P * (d + 1)   // K page (padded rows)
         + (size_t)P * d       // V page
         + 2 * (size_t)G * d   // q, acc
         + (size_t)G * P       // scores, then probabilities
         + 2 * (size_t)G       // m, l
         + (size_t)P;          // visibility of each token
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ pos_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_pos,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, TQ* __restrict__ out,
                    int H, int K, int d, int N, int P, int C, float scale,
                    int window, float softcap) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ldk = d + 1;

  extern __shared__ float smem[];
  float* ks = smem;                 // [P][d + 1]
  float* vs = ks + (size_t)P * ldk; // [P][d]
  float* qs = vs + (size_t)P * d;   // [G][d]
  float* acc = qs + (size_t)G * d;  // [G][d]
  float* sc = acc + (size_t)G * d;  // [G][P]
  float* m_s = sc + (size_t)G * P;  // [G]
  float* l_s = m_s + G;             // [G]
  int* vis = reinterpret_cast<int*>(l_s + G);  // [P]

  const int qp = q_pos[b];
  const size_t head0 = (size_t)b * H + (size_t)kh * G;
  TQ* ob = out + head0 * d;
  if (qp < 0) {  // inactive slot: exact zeros, no page touched
    for (int i = tid; i < G * d; i += blockDim.x) ob[i] = from_f32<TQ>(0.f);
    return;
  }

  const TQ* qb = q + head0 * d;
  for (int i = tid; i < G * d; i += blockDim.x) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int n_live = min(C, qp / P + 1);
  for (int j = 0; j < n_live; ++j) {
    int page = page_table[(size_t)b * C + j];
    page = min(max(page, 0), N - 1);
    const float2 sc2 = page_scales<TKV>(k_scale, v_scale, page, K, kh);
    __syncthreads();  // the previous page's readers are done

    for (int i = tid; i < P * d; i += blockDim.x) {
      const int p = i / d;
      const int c = i - p * d;
      const size_t src = (((size_t)page * P + p) * K + kh) * d + c;
      ks[p * ldk + c] = staged(k_pages[src], sc2.x);
      vs[i] = staged(v_pages[src], sc2.y);
    }
    for (int p = tid; p < P; p += blockDim.x) {
      const int t = pos_pages[(size_t)page * P + p];
      vis[p] = t >= 0 && t <= qp && (window == 0 || qp - t < window);
    }
    __syncthreads();

    // scores: one (head, token) dot product per thread
    for (int i = tid; i < G * P; i += blockDim.x) {
      const int g = i / P;
      const int p = i - g * P;
      const float* qg = qs + (size_t)g * d;
      const float* kp = ks + (size_t)p * ldk;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s += qg[c] * kp[c];
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sc[i] = vis[p] ? s : kNegInf;
    }
    __syncthreads();

    // online softmax + P.V: one warp per query head
    for (int g = warp; g < G; g += n_warps) {
      float* sg = sc + (size_t)g * P;
      float m_cur = kNegInf;
      for (int p = lane; p < P; p += 32) m_cur = fmaxf(m_cur, sg[p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, m_cur);
      float l_cur = 0.f;
      for (int p = lane; p < P; p += 32) {
        // explicit p = 0 on masked entries: with every entry masked m_new
        // stays kNegInf and exp(s - m_new) would be exp(0) = 1
        const float pv = vis[p] ? expf(sg[p] - m_new) : 0.f;
        sg[p] = pv;
        l_cur += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l_cur += __shfl_xor_sync(0xffffffffu, l_cur, o);
      __syncwarp();
      const float alpha = expf(m_prev - m_new);
      float* ag = acc + (size_t)g * d;
      for (int c = lane; c < d; c += 32) {
        float pv_sum = 0.f;
        for (int p = 0; p < P; ++p) pv_sum += sg[p] * vs[(size_t)p * d + c];
        ag[c] = ag[c] * alpha + pv_sum;
      }
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + l_cur;
        m_s[g] = m_new;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < G * d; i += blockDim.x) {
    const int g = i / d;
    ob[i] = from_f32<TQ>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
void launch(const void* q, const void* k, const void* v, const void* pos,
            const void* table, const void* q_pos, const void* k_scale,
            const void* v_scale, void* out, int B, int H, int K, int d, int N,
            int P, int C, float scale, int window, float softcap, size_t smem,
            cudaStream_t s) {
  const dim3 grid(B, K);
  flash_decode_kernel<TQ, TKV><<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<TQ*>(out), H, K, d, N, P, C, scale, window, softcap);
}

// ---------------------------------------------------------------------------
// B9
// ---------------------------------------------------------------------------

constexpr int kMultiRows = 48;  // most query rows (tq queries x G heads) a block holds
constexpr int kSMs = 132;       // H100 SXM

// Shared memory layout of a B9 block, in 4-byte words.
__host__ __device__ inline size_t multi_smem_words(int tq, int G, int d, int P) {
  const size_t R = (size_t)tq * G;
  return (size_t)P * (d + 1)  // K page (padded rows)
         + (size_t)P * d      // V page
         + 2 * R * d          // q rows, acc
         + R * P              // scores, then probabilities
         + 2 * R              // m, l
         + (size_t)tq * P     // visibility of each token to each query
         + (size_t)tq         // q_pos of each query
         + 1;                 // the tile's live page count
}

// Queries per block (see the design note); 0 if one query's rows do not fit.
inline int multi_rows(int B, int K, int T, int G, int d, int P) {
  int tq = std::max(1, kMultiRows / G);
  while (tq > 0 && multi_smem_words(tq, G, d, P) * 4 > kMaxSmem) --tq;
  if (tq == 0) return 0;
  tq = std::min(tq, std::max(T, 1));
  while (tq > 1 && (long long)B * K * ((T + tq - 1) / tq) < kSMs) tq = (tq + 1) / 2;
  return tq;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_decode_multi_kernel(const TQ* __restrict__ q,
                          const TKV* __restrict__ k_pages,
                          const TKV* __restrict__ v_pages,
                          const int* __restrict__ pos_pages,
                          const int* __restrict__ page_table,
                          const int* __restrict__ q_pos,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          TQ* __restrict__ out,
                          int T, int H, int K, int d, int N, int P, int C,
                          int tq, float scale, int window, float softcap) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int t0 = blockIdx.z * tq;
  const int G = H / K;
  const int nt = min(tq, T - t0);  // queries of this tile
  const int R = nt * G;            // rows: r = i * G + g for query t0 + i
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ldk = d + 1;

  extern __shared__ float smem[];
  float* ks = smem;                            // [P][d + 1]
  float* vs = ks + (size_t)P * ldk;            // [P][d]
  float* qs = vs + (size_t)P * d;              // [tq * G][d]
  float* acc = qs + (size_t)tq * G * d;        // [tq * G][d]
  float* sc = acc + (size_t)tq * G * d;        // [tq * G][P]
  float* m_s = sc + (size_t)tq * G * P;        // [tq * G]
  float* l_s = m_s + (size_t)tq * G;           // [tq * G]
  int* vis = reinterpret_cast<int*>(l_s + (size_t)tq * G);  // [tq][P]
  int* qp_s = vis + (size_t)tq * P;            // [tq]
  int* live_s = qp_s + tq;                     // [1]

  // row r of this tile is (query t0 + r / G, head kh * G + r % G)
  auto row_offset = [&](int r) {
    const int i = r / G;
    return (((size_t)b * T + t0 + i) * H + (size_t)kh * G + (r - i * G)) * d;
  };

  for (int i = tid; i < nt; i += blockDim.x) qp_s[i] = q_pos[(size_t)b * T + t0 + i];
  for (int i = tid; i < R * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    qs[i] = to_f32(q[row_offset(r) + c]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int qmax = -1;
    for (int i = 0; i < nt; ++i) qmax = max(qmax, qp_s[i]);
    live_s[0] = qmax < 0 ? 0 : min(C, qmax / P + 1);
  }
  __syncthreads();
  const int n_live = live_s[0];

  for (int j = 0; j < n_live; ++j) {
    int page = page_table[(size_t)b * C + j];
    page = min(max(page, 0), N - 1);
    const float2 sc2 = page_scales<TKV>(k_scale, v_scale, page, K, kh);
    __syncthreads();  // the previous page's readers are done

    for (int i = tid; i < P * d; i += blockDim.x) {
      const int p = i / d;
      const int c = i - p * d;
      const size_t src = (((size_t)page * P + p) * K + kh) * d + c;
      ks[p * ldk + c] = staged(k_pages[src], sc2.x);
      vs[i] = staged(v_pages[src], sc2.y);
    }
    for (int i = tid; i < nt * P; i += blockDim.x) {
      const int qi = i / P;
      const int p = i - qi * P;
      const int t = pos_pages[(size_t)page * P + p];
      const int qp = qp_s[qi];
      vis[i] = t >= 0 && t <= qp && (window == 0 || qp - t < window);
    }
    __syncthreads();

    // scores: one (row, token) dot product per thread
    for (int i = tid; i < R * P; i += blockDim.x) {
      const int r = i / P;
      const int p = i - r * P;
      const float* qr = qs + (size_t)r * d;
      const float* kp = ks + (size_t)p * ldk;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s += qr[c] * kp[c];
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sc[i] = vis[(r / G) * P + p] ? s : kNegInf;
    }
    __syncthreads();

    // online softmax + P.V: one warp per row
    for (int r = warp; r < R; r += n_warps) {
      float* sr = sc + (size_t)r * P;
      const int* vr = vis + (size_t)(r / G) * P;
      float m_cur = kNegInf;
      for (int p = lane; p < P; p += 32) m_cur = fmaxf(m_cur, sr[p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float l_cur = 0.f;
      for (int p = lane; p < P; p += 32) {
        // explicit p = 0 on masked entries (a page past this row's
        // position, or a row at -1): exp(s - m_new) would be 1 there
        const float pv = vr[p] ? expf(sr[p] - m_new) : 0.f;
        sr[p] = pv;
        l_cur += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l_cur += __shfl_xor_sync(0xffffffffu, l_cur, o);
      __syncwarp();
      const float alpha = expf(m_prev - m_new);
      float* ar = acc + (size_t)r * d;
      for (int c = lane; c < d; c += 32) {
        float pv_sum = 0.f;
        for (int p = 0; p < P; ++p) pv_sum += sr[p] * vs[(size_t)p * d + c];
        ar[c] = ar[c] * alpha + pv_sum;
      }
      if (lane == 0) {
        l_s[r] = alpha * l_s[r] + l_cur;
        m_s[r] = m_new;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < R * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    out[row_offset(r) + c] = from_f32<TQ>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename TQ, typename TKV>
void launch_multi(const void* q, const void* k, const void* v, const void* pos,
                  const void* table, const void* q_pos, const void* k_scale,
                  const void* v_scale, void* out, int B, int T, int H, int K,
                  int d, int N, int P, int C, int tq, float scale, int window,
                  float softcap, size_t smem, cudaStream_t s) {
  const dim3 grid(B, K, (T + tq - 1) / tq);
  flash_decode_multi_kernel<TQ, TKV><<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<TQ*>(out), T, H, K, d, N, P, C, tq, scale, window, softcap);
}

}  // namespace

// Shared memory one block needs, in bytes; the wrapper refuses shapes above
// the 48 KB a block gets without opting in.
extern "C" long long repro_flash_decode_smem_bytes(int G, int d, int P) {
  return static_cast<long long>(smem_words(G, d, P) * 4);
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 with (N, K) float32 k_scale / v_scale (null for the other pool
// types); out has q's dtype.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pos, const void* table,
                                  const void* q_pos, const void* k_scale,
                                  const void* v_scale, void* out, int B, int H,
                                  int K, int d, int N, int P, int C,
                                  float scale, int window, float softcap,
                                  int q_dtype, int kv_dtype, void* stream) {
  const size_t smem = smem_words(H / K, d, P) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                 \
  launch<TQ, TKV>(q, k, v, pos, table, q_pos, k_scale, v_scale, out, B, H, K, \
                  d, N, P, C, scale, window, softcap, smem, s)
  if (q_dtype == 0 && kv_dtype == 0) {
    REPRO_LAUNCH(float, float);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    REPRO_LAUNCH(float, __nv_bfloat16);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    REPRO_LAUNCH(__nv_bfloat16, float);
  } else if (q_dtype == 0 && kv_dtype == 2) {
    REPRO_LAUNCH(float, int8_t);
  } else if (q_dtype == 1 && kv_dtype == 2) {
    REPRO_LAUNCH(__nv_bfloat16, int8_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// B9's queries per block for these shapes (0: one query's rows do not fit
// the 48 KB of shared memory), and the shared memory one block then needs.
extern "C" int repro_flash_decode_multi_rows(int B, int K, int T, int G, int d,
                                             int P) {
  return multi_rows(B, K, T, G, d, P);
}

extern "C" long long repro_flash_decode_multi_smem_bytes(int tq, int G, int d,
                                                         int P) {
  return static_cast<long long>(multi_smem_words(tq, G, d, P) * 4);
}

// q (B, T, H, d), q_pos (B, T), out like q; dtypes and scales as
// repro_flash_decode.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_flash_decode_multi(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        const void* table, const void* q_pos,
                                        const void* k_scale,
                                        const void* v_scale,
                                        void* out, int B, int T, int H, int K,
                                        int d, int N, int P, int C,
                                        float scale, int window, float softcap,
                                        int q_dtype, int kv_dtype,
                                        void* stream) {
  const int tq = multi_rows(B, K, T, H / K, d, P);
  if (tq == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = multi_smem_words(tq, H / K, d, P) * 4;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                \
  launch_multi<TQ, TKV>(q, k, v, pos, table, q_pos, k_scale, v_scale, out, \
                        B, T, H, K, d, N, P, C, tq, scale, window, softcap, \
                        smem, s)
  if (q_dtype == 0 && kv_dtype == 0) {
    REPRO_LAUNCH(float, float);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    REPRO_LAUNCH(float, __nv_bfloat16);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    REPRO_LAUNCH(__nv_bfloat16, float);
  } else if (q_dtype == 0 && kv_dtype == 2) {
    REPRO_LAUNCH(float, int8_t);
  } else if (q_dtype == 1 && kv_dtype == 2) {
    REPRO_LAUNCH(__nv_bfloat16, int8_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
