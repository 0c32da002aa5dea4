// Paged flash decode for Hopper (sm_90a): B8, one query per slot, and B9,
// a chunk of T queries per slot.  Two separate __global__ functions, so the
// launch counts say which path ran.
//
// Pools are float32, bfloat16 or int8 (TKV).  Int8 pools come with (N, K)
// float32 scales, one per page per kv head (the reference's kv_quant mode,
// decode_attention.py:79-83 for B8 and :158-160 for B9): both kernels
// dequantize as float(int8) * scale, in the reference's order, and read a
// page's two scales once; everything after (masks, online softmax, exact
// zeros for rows at -1) is the float path's.  The wrappers count int8
// launches apart, so a launch count says which pool type ran.
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
// What bounds it on the H100: latency, then device-memory bandwidth.  Each
// live K/V byte feeds 2 * G flops (the G query heads of one kv head share
// it): ~1.5 flop/byte at G = 3 over f32 pools, ~6 over int8, far below the
// ~295 flop/byte ridge, and at the serve's decode shape (4 slots, 8-20 live
// pages of 16 tokens) the live bytes take under half a microsecond at 3.35
// TB/s.  What is left is launch, the dependent trips to device memory and
// synchronisation; the tensor cores do not apply (G = 3 rows of a 16-row
// MMA; TF32 would leave the f32 tier; int8 MMA would quantize q, which the
// reference never does).
//
// What the design does about it:
//  - Split-KV in one launch: grid (B, K, S) with clusters of (1, 1, S)
//    blocks, S = decode_splits() on the host (at most 8, the portable
//    cluster size).  The slot's live pages, n_live = min(C, q_pos/P + 1),
//    are dealt to the S x kWarps warps of the cluster: page j goes to
//    cluster warp j mod (S kWarps), where warp w of block rank r is cluster
//    warp w S + r, so consecutive pages land on different SMs.  None for
//    q_pos < 0.  At the decode shape 96 blocks share the 58 live pages
//    (20 for the longest slot), one page a warp, where one block per (slot,
//    kv head) walked up to 20 pages in a row.
//  - Pages straight into registers, no shared memory and no __syncthreads
//    in the page loop.  A token row is read in 16-byte chunks (float4 for
//    f32, 8 bf16 or 16 int8 values), LR lanes a row (the power of two that
//    covers d / chunk, at most 32 lanes and 256 columns), consecutive lanes
//    on consecutive addresses; a lane holds RS rows of K and of V per step
//    (Chunk<TKV>), 16 rows at d = 64 in every pool type: the whole page.
//    The first 32 page ids of a warp are read in one load with q_pos and q,
//    so a page costs two dependent round trips (table, then positions,
//    scales and data).  Every load of a step is issued in one straight run
//    of code before the loop of products: ptxas otherwise interleaves the K
//    loads with the FMAs that wait for them, which costs a round trip more.
//  - q . k over d: each lane's chunk against q in registers, then
//    __shfl_xor_sync among the LR lanes of the row.  Int8 elements become
//    float(byte) * scale before the product, as the reference's order.
//  - Each warp keeps its own online softmax (m, l, acc) for kHeads query
//    heads in registers, in f32, with p = 0 written on masked entries.
//  - Merge without a second pass (each merge: one warp weighs the states,
//    merge_weights, then every thread sums its columns): the warps of a
//    block merge through shared memory, and each block stores its merged
//    state into rank 0's shared memory (distributed shared memory,
//    map_shared_rank; stores do not wait for their round trip as loads
//    would).  One cluster.sync makes them visible; rank 0 merges the
//    blocks in rank order from its own shared memory and writes out, and
//    the other blocks exit (another pass over heads or columns first syncs
//    again, since it rewrites the stage).  A state that saw no visible entry (m = kNegInf, l = 0, acc =
//    0: a split with no page, or all masked) merges with weight 0, never
//    exp(0) = 1; the final divide is guarded, so an inactive slot or a fully
//    masked row gives exact zeros.  No scratch tensor, no atomics.
//  - Any shape: G in passes of kHeads query heads, P in steps of RS row
//    slots, d in slices of 256 columns (128 over f32 pools; wider heads
//    recompute the scores for each slice).  16-byte loads need d a multiple
//    of the chunk and 16-byte aligned pools (the WIDE instances), else a
//    chunk is read byte by byte.  Page ids are clamped to [0, N-1], as the
//    TPU wrapper does (decode_attention.py:225).
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
//    (coalesced, converted to f32 -- int8 bytes times their page's scale --,
//    K rows padded by one float against bank conflicts).
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
// Later work, not done here: the (tq G x d) . (d x P) products on the
// tensor cores (tq G rows fill an MMA, unlike B8's G), int8 MMA with the
// scales on the logits over int8 pools, B8's 16-byte loads into registers,
// split-KV, cp.async/TMA double buffering.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"

namespace {

namespace cg = cooperative_groups;
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
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// B8
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;      // warps a block (decode_attention.py DECODE_WARPS)
constexpr int kMaxSplits = 8;  // blocks a cluster: the portable cluster size
constexpr int kHeads = 3;      // query heads a pass keeps in registers

// A row of the pool is read in 16-byte chunks of E elements; a lane loads
// RS rows of K and of V per step.
template <typename TKV> struct Chunk;
template <> struct Chunk<float> { static constexpr int E = 4, RS = 8; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int E = 8, RS = 4; };
template <> struct Chunk<int8_t> { static constexpr int E = 16, RS = 2; };

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// Element i of a chunk as f32 (exact for every pool type).
template <typename TKV> __device__ __forceinline__ float elem(const uint4& u, int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int i) {
  return __uint_as_float(word(u, i));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int i) {
  const uint32_t w = word(u, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <> __device__ __forceinline__ float elem<int8_t>(const uint4& u, int i) {
  const uint32_t w = word(u, i >> 2);
  return static_cast<float>(static_cast<int>(w << (24 - 8 * (i & 3))) >> 24);
}

// Element i of a chunk as the reference reads it: times the page's scale
// for int8 pools.
template <typename TKV>
__device__ __forceinline__ float dequant(const uint4& u, int i, float s) {
  if constexpr (std::is_same<TKV, int8_t>::value) {
    return elem<TKV>(u, i) * s;
  } else {
    return elem<TKV>(u, i);
  }
}

// The chunk of a row that starts at column c0 (< d): one 16-byte load when
// WIDE (d a multiple of E, 16-byte aligned rows), else byte by byte with
// zeros past d.
template <typename TKV, bool WIDE>
__device__ __forceinline__ uint4 load_chunk(const TKV* __restrict__ row, int c0, int d) {
  if constexpr (WIDE) {
    return __ldg(reinterpret_cast<const uint4*>(row + c0));
  }
  const unsigned char* p = reinterpret_cast<const unsigned char*>(row + c0);
  const int n = min(Chunk<TKV>::E, d - c0) * static_cast<int>(sizeof(TKV));
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * k + j < n) x |= static_cast<uint32_t>(__ldg(p + 4 * k + j)) << (8 * j);
    w[k] = x;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// q of heads [0, gn) of qh at columns c0 .. c0 + E - 1, zeros past them.
template <typename TQ, int E>
__device__ __forceinline__ void load_q(float (&qr)[kHeads][E], const TQ* __restrict__ qh,
                                       int gn, int c0, int d) {
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = (g < gn && c0 + e < d) ? to_f32(qh[(size_t)g * d + c0 + e]) : 0.f;
}

// The cluster barrier split in two: every block arrives once it runs and
// waits before its first store into another block's shared memory, which
// then exists (blocks of a cluster start together, but only the barrier
// says so).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Lanes a row: the power of two that covers a row's chunks, at most 32 and
// at most 256 columns (a slice: wider rows go by slices).
template <typename TKV>
constexpr int kMaxLanes = 256 / Chunk<TKV>::E < 32 ? 256 / Chunk<TKV>::E : 32;

// A block's shared memory: each warp's state over its pages for the pass's
// heads and column slice and its weight in the block's merge; in rank 0,
// every block's state merged over its warps (stage, written by each block
// into rank 0's shared memory), the blocks' weights and the sum of l.
template <typename TKV>
struct DecodeSmem {
  static constexpr int W = kMaxLanes<TKV> * Chunk<TKV>::E;  // columns of a slice
  float acc[kWarps][kHeads][W];
  float m[kWarps][kHeads];
  float l[kWarps][kHeads];
  float wt[kWarps][kHeads];
  float stage_acc[kMaxSplits][kHeads][W];
  float stage_m[kMaxSplits][kHeads];
  float stage_l[kMaxSplits][kHeads];
  float stage_wt[kMaxSplits][kHeads];
  float lt[kHeads];
};

// The weights of n <= NS online-softmax states (m, l) of gn heads in a
// merge, by one warp, lane n' + NS g for state n', head g: m the largest m,
// wt[n'][g] = exp(m_n' - m), 0 for a state that saw nothing (l = 0, never
// exp(0) = 1), and l the sum of wt l over the states in order (in the
// head's first lane).
template <int NS>
__device__ __forceinline__ void merge_weights(const float (&ms)[NS][kHeads],
                                              const float (&ls)[NS][kHeads],
                                              float (&wts)[NS][kHeads], int n, int gn,
                                              float& m, float& l) {
  static_assert(NS * kHeads <= 32, "one warp");
  const int lane = threadIdx.x & 31;
  const int i = lane % NS, g = lane / NS;
  const bool live = i < n && g < gn;
  const float mi = live ? ms[i][g] : kNegInf;
  const float li = live ? ls[i][g] : 0.f;
  m = mi;
#pragma unroll
  for (int o = 1; o < NS; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const float wt = li > 0.f ? expf(mi - m) : 0.f;
  if (live) wts[i][g] = wt;
  const float wl = wt * li;
  l = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) l += __shfl_sync(kFull, wl, (lane & ~(NS - 1)) + j);
}

template <typename TQ, typename TKV, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ pos_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_pos,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, TQ* __restrict__ out,
                    int H, int K, int d, int N, int P, int C, float scale,
                    int window, float softcap) {
  constexpr int E = Chunk<TKV>::E;
  constexpr int RS = Chunk<TKV>::RS;
  constexpr int SW = DecodeSmem<TKV>::W;
  constexpr int ML = kMaxLanes<TKV>;
  __shared__ DecodeSmem<TKV> sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NW = S * kWarps;      // warps of the cluster
  const int cw = warp * S + rank; // this warp's pages: j = cw, cw + NW, ...
  const size_t head0 = (size_t)b * H + (size_t)kh * G;
  const int* tab = page_table + (size_t)b * C;
  DecodeSmem<TKV>* stage = cluster.map_shared_rank(&sm, 0);  // rank 0's

  // first round trip: q_pos and the page ids of this warp's first 32 pages
  const int qp = q_pos[b];
  const int tab0 = cw + lane * NW < C ? tab[cw + lane * NW] : 0;
  if (qp < 0) {  // inactive slot: exact zeros, no page touched
    if (rank == 0)
      for (int i = threadIdx.x; i < G * d; i += blockDim.x) out[head0 * d + i] = from_f32<TQ>(0.f);
    return;
  }
  cluster_arrive();
  const int n_live = min(C, qp / P + 1);
  const int n_mine = cw < n_live ? (n_live - cw + NW - 1) / NW : 0;

  const int NC = (d + E - 1) / E;  // chunks a row
  int LR = 1;                      // lanes a row
  while (LR < NC && LR < ML) LR <<= 1;
  const int lr = lane & (LR - 1);  // this lane's chunk of the row
  const int rw = lane / LR;        // this lane's row of the warp's load
  const int RPW = 32 / LR;         // rows a warp-wide load covers
  const int n_sl = (NC + ML - 1) / ML;  // column slices of ML chunks
  const size_t ld = (size_t)K * d; // pool row stride
  // softcap * tanh(s / softcap) with the division as a product: an IEEE
  // divide in the page loop is a call that makes ptxas save registers
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int g0 = 0; g0 < G; g0 += kHeads) {
    const int gn = min(kHeads, G - g0);
    const TQ* qh = q + (head0 + g0) * d;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int cv = (sl * ML + lr) * E;  // this lane's columns of V and acc
      float qr[kHeads][E];
      load_q<TQ, E>(qr, qh, gn, lr * E, d);
      float acc[kHeads][E], m[kHeads], l[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
      }

      int tab_cur = tab0;
      for (int i = 0; i < n_mine; ++i) {
        if (i > 0 && (i & 31) == 0) {
          const int j = cw + (i + lane) * NW;
          tab_cur = j < C ? tab[j] : 0;
        }
        int page = __shfl_sync(kFull, tab_cur, i & 31);
        page = min(max(page, 0), N - 1);
        const float2 sc2 = page_scales<TKV>(k_scale, v_scale, page, K, kh);
        const TKV* kpg = k_pages + (size_t)page * P * ld + (size_t)kh * d;
        const TKV* vpg = v_pages + (size_t)page * P * ld + (size_t)kh * d;
        const int* ppg = pos_pages + (size_t)page * P;

        for (int r0 = 0; r0 < P; r0 += RS * RPW) {
          // second round trip: every load of the step's rows (K of the first
          // slice, V of this lane's slice, positions) before any product
          if (n_sl > 1) load_q<TQ, E>(qr, qh, gn, lr * E, d);
          int pos[RS];
          uint4 kc[RS], vc[RS];
#pragma unroll
          for (int s = 0; s < RS; ++s) {
            const int r = r0 + s * RPW + rw;
            const bool row = r < P;
            pos[s] = row ? __ldg(ppg + r) : -1;
            kc[s] = (row && lr * E < d) ? load_chunk<TKV, WIDE>(kpg + r * ld, lr * E, d)
                                        : make_uint4(0u, 0u, 0u, 0u);
            vc[s] = (row && cv < d) ? load_chunk<TKV, WIDE>(vpg + r * ld, cv, d)
                                    : make_uint4(0u, 0u, 0u, 0u);
          }
          float sc[kHeads][RS];  // scores, then probabilities
#pragma unroll
          for (int g = 0; g < kHeads; ++g)
#pragma unroll
            for (int s = 0; s < RS; ++s) sc[g][s] = 0.f;
          for (int sk = 0;;) {
#pragma unroll
            for (int s = 0; s < RS; ++s)
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const float kv = dequant<TKV>(kc[s], e, sc2.x);
#pragma unroll
                for (int g = 0; g < kHeads; ++g) sc[g][s] = fmaf(qr[g][e], kv, sc[g][s]);
              }
            if (++sk == n_sl) break;
            // rows wider than a slice: q and K of the next slice
            const int ck = (sk * ML + lr) * E;
            load_q<TQ, E>(qr, qh, gn, ck, d);
#pragma unroll
            for (int s = 0; s < RS; ++s) {
              const int r = r0 + s * RPW + rw;
              kc[s] = (r < P && ck < d) ? load_chunk<TKV, WIDE>(kpg + r * ld, ck, d)
                                        : make_uint4(0u, 0u, 0u, 0u);
            }
          }
          // each row's dot product over its LR lanes
          for (int o = LR >> 1; o > 0; o >>= 1)
#pragma unroll
            for (int g = 0; g < kHeads; ++g)
#pragma unroll
              for (int s = 0; s < RS; ++s)
                sc[g][s] += __shfl_xor_sync(kFull, sc[g][s], o);

          bool vis[RS];
#pragma unroll
          for (int s = 0; s < RS; ++s)
            vis[s] = pos[s] >= 0 && pos[s] <= qp && (window == 0 || qp - pos[s] < window);
#pragma unroll
          for (int g = 0; g < kHeads; ++g) {
            if (g >= gn) break;
            float m_cur = kNegInf;
#pragma unroll
            for (int s = 0; s < RS; ++s) {
              float x = sc[g][s] * scale;
              if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
              sc[g][s] = vis[s] ? x : kNegInf;
              m_cur = fmaxf(m_cur, sc[g][s]);
            }
            for (int o = LR; o < 32; o <<= 1)
              m_cur = fmaxf(m_cur, __shfl_xor_sync(kFull, m_cur, o));
            const float m_new = fmaxf(m[g], m_cur);
            float l_cur = 0.f;
#pragma unroll
            for (int s = 0; s < RS; ++s) {
              // explicit p = 0 on masked entries: with every entry masked
              // m_new stays kNegInf and exp(s - m_new) would be exp(0) = 1
              const float p = expf(sc[g][s] - m_new);
              sc[g][s] = vis[s] ? p : 0.f;
              l_cur += sc[g][s];
            }
            for (int o = LR; o < 32; o <<= 1) l_cur += __shfl_xor_sync(kFull, l_cur, o);
            const float alpha = expf(m[g] - m_new);
            l[g] = alpha * l[g] + l_cur;
            m[g] = m_new;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
          }
#pragma unroll
          for (int s = 0; s < RS; ++s)
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float vv = dequant<TKV>(vc[s], e, sc2.y);
#pragma unroll
              for (int g = 0; g < kHeads; ++g) acc[g][e] = fmaf(sc[g][s], vv, acc[g][e]);
            }
        }
      }

      // the warp's state: acc summed over the lanes that hold other rows
      for (int o = LR; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < kHeads; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
      if (rw == 0) {
#pragma unroll
        for (int g = 0; g < kHeads; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) sm.acc[warp][g][lr * E + e] = acc[g][e];
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          sm.m[warp][g] = m[g];
          sm.l[warp][g] = l[g];
        }
      }
      __syncthreads();

      // the block's state, merged over its warps in order, stored into rank
      // 0's stage (distributed shared memory): a thread a head weighs the
      // warps (one that saw nothing, l = 0, weighs 0, never exp(0) = 1),
      // then every thread sums its columns
      const int cols = min(SW, d - sl * SW);
      if (g0 == 0 && sl == 0) cluster_wait();  // rank 0 runs
      if (warp == 0) {
        float mb, lb;
        merge_weights<kWarps>(sm.m, sm.l, sm.wt, kWarps, gn, mb, lb);
        if (lane % kWarps == 0 && lane / kWarps < gn) {
          stage->stage_m[rank][lane / kWarps] = mb;
          stage->stage_l[rank][lane / kWarps] = lb;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < gn * cols; i += blockDim.x) {
        const int g = i / cols;
        const int c = i - g * cols;
        float ab = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ab += sm.wt[w][g] * sm.acc[w][g][c];
        stage->stage_acc[rank][g][c] = ab;
      }
      cluster.sync();  // every block's state is in rank 0's stage

      // rank 0 merges the blocks in rank order and writes out
      if (rank == 0) {
        if (warp == 0) {
          float mc, lt;
          merge_weights<kMaxSplits>(sm.stage_m, sm.stage_l, sm.stage_wt, S, gn, mc, lt);
          if (lane % kMaxSplits == 0 && lane / kMaxSplits < gn) sm.lt[lane / kMaxSplits] = lt;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < gn * cols; i += blockDim.x) {
          const int g = i / cols;
          const int c = i - g * cols;
          float at = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxSplits; ++r)
            if (r < S) at += sm.stage_wt[r][g] * sm.stage_acc[r][g][c];
          out[(head0 + g0 + g) * d + sl * SW + c] = from_f32<TQ>(at / fmaxf(sm.lt[g], 1e-30f));
        }
      }
      // another pass rewrites the warps' states and rank 0's stage
      if (sl + 1 < n_sl || g0 + kHeads < G) cluster.sync();
    }
  }
}

// Launches B8 over a cluster of `splits` blocks for each (slot, kv head);
// returns the launch's error (a refused cluster launch included).
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* table, const void* q_pos, const void* k_scale,
                   const void* v_scale, void* out, int B, int H, int K, int d, int N,
                   int P, int C, float scale, int window, float softcap, int splits,
                   cudaStream_t s) {
  const bool wide = (d * sizeof(TKV)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, K, splits);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = wide ? flash_decode_kernel<TQ, TKV, true> : flash_decode_kernel<TQ, TKV, false>;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
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

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 with (N, K) float32 k_scale / v_scale (null for the other pool
// types); out has q's dtype; splits: blocks of a cluster, 1..8
// (decode_attention.py decode_splits).  Returns the launch's error or
// cudaGetLastError() after it (0 on success).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pos, const void* table,
                                  const void* q_pos, const void* k_scale,
                                  const void* v_scale, void* out, int B, int H,
                                  int K, int d, int N, int P, int C,
                                  float scale, int window, float softcap,
                                  int splits, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (splits < 1 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_LAUNCH(TQ, TKV)                                                       \
  err = launch<TQ, TKV>(q, k, v, pos, table, q_pos, k_scale, v_scale, out, B, H, K, \
                        d, N, P, C, scale, window, softcap, splits, s)
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
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises with this code
    return static_cast<int>(err);
  }
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
