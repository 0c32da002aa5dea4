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
// What bounds it on the H100: at the engine's chunk (T = 64, G = 3, 16 live
// pages of 16) the function is 33 MFLOP over 0.7 MB: 0.5 us of f32 FFMA
// at 67 TFLOP/s.  What sets a launch is latency and the shared-memory
// pipe: the launch, two dependent trips to memory (table, then pages), the
// merge, and products whose operands come from shared memory.  Above ~1
// GFLOP (a chunk of 256 over a 2048-token history) the products take
// over.  They stay f32 FFMA: TF32 or bf16 operands would leave the f32
// tier (atol 2e-5) on which the serve's greedy tokens rest.
//
// What the design does about it (scripts/torch_decode_probe.py times
// each phase from %globaltimer stamps in an instrumented copy, and sweeps
// the plan):
//  - Many rows a block: a block owns (slot b, kv head, a tile of tq
//    queries): R = tq G <= 64 rows (kMaxRows), tiles balanced over T, so
//    each staged page feeds R rows (3 before).  q of the tile lives in
//    shared memory (f32); m, l and acc in registers: 256 threads, 16 row
//    groups of 16 consecutive lanes, a thread holding rows ig + 16 a (a <
//    4), in the products a rows x tokens tile of q . k^T (tokens jl + 16 t
//    of a step of up to 64) and a rows x columns tile of p . v (columns 4
//    (jl + 16 cv), cv < CV: 64 CV columns a slice, CV = 1 for d <= 64,
//    else 4; wider heads go by slices of 256 and recompute the scores).
//    A step is specialised on its tokens a thread (TN = 1..4), so the
//    loops are straight-line code: runtime guards inside them cost half as
//    much again as the work they skipped.  A row's max and sum are reduced
//    by shuffles over its 16 lanes, the rows' shuffles interleaved.  Each
//    dot product sums its 4-element chunks pairwise first, a shorter chain
//    of roundings at wide heads.
//  - Split-KV over a thread-block cluster, as B8: grid (S tiles B, K),
//    clusters of (S, 1, 1).  The tile's live pages, n_live = min(C,
//    max q_pos of the tile // P + 1), go page j to rank j mod S.
//    multi_plan picks S <= 8 to minimise waves(S) (F + C R / S): a block
//    costs a fixed F (launch, the trips, the merge: ~6 us at the chunk
//    shape, as much as ~150 (page, row) pairs of products) plus its pages,
//    one block an SM (registers), waves counted over the device's SMs
//    (cudaDevAttrMultiProcessorCount, 132 on an H100 SXM).  At the chunk
//    shape that is 8 splits (96 blocks of 2 pages), at 32 slots 1, at a
//    chunk of 256 over 2048 tokens 3.  F was fitted at the chunk shape; the
//    probe's sweep holds the choice at the verify and scaling shapes.
//  - Loads in two dependent runs: the block's page ids (clamped to [0,
//    N-1]), q (16-byte loads, up to 8 a thread in flight) and q_pos in
//    one; then every page of a slot (K and V rows of the kv head,
//    positions, and the two scales over int8 pools) with 16-byte cp.async,
//    one wait.  f32 pools land in their f32 layout (K rows at a stride of
//    d + 4 floats: the 8 lanes of a 16-byte phase on 8 bank quads); bf16
//    and int8 pools land as bytes and one pass converts them (int8 bytes
//    times the page's scale, the reference's order).  Pages that do not
//    fit 227 KB go through a ring of two slots, the next slot's copy in
//    flight during this slot's products.  Rows that are not 16-byte chunks
//    (d_head 20 in bf16) are read byte by byte instead.
//  - Merge without a second launch, spread over the cluster: row r goes to
//    rank r mod S; every block stores its (m, l, acc) of each row into that
//    block's stage (distributed shared memory: a store does not wait for
//    its round trip, where remote loads run in series, as B8's probe
//    showed), one cluster.sync publishes them, and each block merges its
//    rows in rank order (a warp a row: the max by shuffles, l summed in
//    rank order) and writes them out.  Spread, no block merges more than
//    ceil(R / S) rows, where gathering into rank 0 would merge all R.  A
//    state that saw nothing (l = 0: an empty split, a row at q_pos -1, a
//    row past T in the last tile) weighs 0, never exp(0) = 1; the guarded
//    divide gives exact zeros.  No scratch tensor, no atomics, one launch
//    a call.
//  - Masks as the reference: entry s of a row is visible iff pos_s >= 0,
//    pos_s <= q_pos and (window) q_pos - pos_s < window; p = 0 is written
//    on masked entries.  Pages shared between slots by the prefix cache
//    are only read here.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

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

constexpr float kNegInf = -2.3819763e38f;  // the reference's masking constant
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

constexpr int kMThreads = 256;                    // threads a B9 block
constexpr int kRowLanes = 16;                     // consecutive lanes that share a row
constexpr int kRowGroups = kMThreads / kRowLanes; // 16
constexpr int kRowsThread = 4;                    // rows a thread holds
constexpr int kMaxRows = kRowGroups * kRowsThread;  // 64 query rows (tq x G) a block
constexpr int kStepTok = 64;                      // tokens a step of products
constexpr int kTokThread = kStepTok / kRowLanes;  // a thread's tokens of a step
constexpr int kPsLd = kStepTok + 16;  // p row stride: the two rows of a warp on other banks
// a block's fixed time (launch, the two trips, the merge: ~6 us) in (page,
// row) pairs of products (0.03-0.06 us a pair; scripts/torch_decode_probe.py)
constexpr long long kSplitFixed = 150;
constexpr size_t kMaxDynSmem = 232448;  // 227 KB, the most a block may opt in to

// Shared memory of a B9 block, byte offsets (16-byte aligned pieces).  A
// slot holds H pages: K rows in f32 at stride ldk (d rounded up to 4, plus
// 4 floats when that is a multiple of 8, so the 8 lanes of a 16-byte load
// phase hit 8 different bank quads), V rows in f32, positions, the two
// scales, and for bf16/int8 pools the raw bytes that cp.async brings (one
// conversion pass turns them into f32).  Then q (R rows in f32), p of a
// step, and the merge stage: each cluster block's (m, l, acc) of the rows
// this block merges (rows rank, rank + S, ...).
struct MultiLayout {
  int dpad, ldk, sw, rs, row_bytes;
  size_t ids, kf, vf, raw, pos, scl, qs, ps, stm, stl, sta, wts, lsum, total;
  __host__ __device__ MultiLayout(int R, int S, int H, int slots, int d, int P, int C,
                                  int kv_bytes, int slice_cols) {
    dpad = (d + 3) / 4 * 4;
    ldk = dpad % 8 == 0 ? dpad + 4 : dpad;
    sw = dpad < slice_cols ? dpad : slice_cols;
    rs = (R + S - 1) / S;
    row_bytes = (d * kv_bytes + 15) / 16 * 16;
    const size_t pages = (size_t)slots * H;
    size_t o = 0;
    auto take = [&o](size_t bytes) {
      const size_t at = o;
      o += (bytes + 15) / 16 * 16;
      return at;
    };
    ids = take((size_t)((C + S - 1) / S) * 4);
    kf = take(pages * P * ldk * 4);
    vf = take(pages * P * dpad * 4);
    raw = take(kv_bytes == 4 ? 0 : pages * 2 * P * row_bytes);
    pos = take(pages * P * 4);
    scl = take(pages * 2 * 4);
    qs = take((size_t)R * dpad * 4);
    ps = take((size_t)R * kPsLd * 4);
    stm = take((size_t)S * rs * 4);
    stl = take((size_t)S * rs * 4);
    sta = take((size_t)S * rs * sw * 4);
    wts = take((size_t)rs * S * 4);
    lsum = take((size_t)rs * 4);
    total = o;
  }
};

constexpr int kMaxDevices = 64;

// The current device's SM count into *sms (multi_plan's waves), read once a
// device.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

// The plan of a B9 launch (see the design note): tq queries a tile (tq G
// rows), splits blocks a cluster, the block's pages in slots of
// stage_pages, the column slices' width class cv (64 cv columns a slice),
// and the shared memory a block needs.  tq = 0: the shape cannot be placed
// (G > kMaxRows, or one page a slot does not fit); smem then holds what the
// smallest layout would need.
struct MultiPlan {
  int tq, splits, tiles, stage_pages, slots, cv;
  size_t smem;
};

inline MultiPlan multi_plan(int B, int K, int T, int G, int d, int P, int C, int kv_bytes,
                            int sms, int tq_force = 0, int splits_force = 0) {
  MultiPlan p{};
  p.cv = d <= 64 ? 1 : 4;
  const int cols = kRowLanes * 4 * p.cv;
  T = std::max(T, 1);
  C = std::max(C, 1);
  if (G > kMaxRows) {
    p.smem = MultiLayout(G, 1, 1, 1, d, P, C, kv_bytes, cols).total;
    return p;
  }
  // balanced tiles of at most kMaxRows rows; where not even a ring of two
  // one-page slots fits beside that many rows (wide heads over int8 or bf16
  // pools, whose raw bytes sit beside the f32 staging: gemma2-2b's d_head
  // 256 at 64 rows), balanced tiles of fewer rows, down to one query a tile
  int tq = tq_force > 0 ? std::min(tq_force, T) : 0;
  if (tq == 0) {
    const int tiles = (T + kMaxRows / G - 1) / (kMaxRows / G);
    tq = (T + tiles - 1) / tiles;
  }
  for (;;) {
    p.tq = tq;
    p.tiles = (T + p.tq - 1) / p.tq;
    if (splits_force > 0) {
      p.splits = splits_force;
    } else {
      // fill the card through the splits: S minimises waves(S) (F + C R / S),
      // a block's time being a fixed part F (launch, two trips, the merge)
      // and its pages' products, waves(S) = ceil(B K tiles S / sms) at one
      // block an SM; compared as integers, cost(S) = num / S
      const long long bkt = (long long)B * K * p.tiles;
      const long long work = (long long)C * p.tq * G;
      long long best_num = 0;
      p.splits = 1;
      for (int S = 1; S <= std::min(kMaxSplits, C); ++S) {
        const long long num = (bkt * S + sms - 1) / sms * (kSplitFixed * S + work);
        if (S == 1 || num * p.splits < best_num * S) {
          best_num = num;
          p.splits = S;
        }
      }
    }
    const int S = p.splits;
    const int R = p.tq * G;
    const int ppb = (C + S - 1) / S;  // the most pages a block can own
    p.stage_pages = ppb;
    p.slots = 1;
    p.smem = MultiLayout(R, S, ppb, 1, d, P, C, kv_bytes, cols).total;
    if (p.smem <= kMaxDynSmem) return p;
    // a ring of two slots: the next slot's copy in flight during this one's products
    p.slots = 2;
    for (int h = ppb - 1; h >= 1; --h) {
      p.stage_pages = h;
      p.smem = MultiLayout(R, S, h, 2, d, P, C, kv_bytes, cols).total;
      if (p.smem <= kMaxDynSmem) return p;
    }
    if (tq_force > 0 || tq == 1) break;
    const int tiles = (T + tq - 2) / (tq - 1);  // tiles of at most tq - 1 queries
    tq = (T + tiles - 1) / tiles;
  }
  p.tq = 0;  // p.smem: one page a slot, at the fewest rows tried
  return p;
}

// Element i of 16 bytes of pool values as the reference reads it (int8
// bytes times their page's scale).
template <typename TKV>
__device__ __forceinline__ float4 dequant4(const uint4& u, int i, float s) {
  return make_float4(dequant<TKV>(u, i, s), dequant<TKV>(u, i + 1, s),
                     dequant<TKV>(u, i + 2, s), dequant<TKV>(u, i + 3, s));
}

__device__ __forceinline__ void fma4(float (&a)[4], float p, const float4& v) {
  a[0] = fmaf(p, v.x, a[0]);
  a[1] = fmaf(p, v.y, a[1]);
  a[2] = fmaf(p, v.z, a[2]);
  a[3] = fmaf(p, v.w, a[3]);
}

// s + a . b, the four products summed pairwise first: a shorter chain of
// roundings than four fused steps, which wide heads over long histories
// need to keep well inside the f32 tier
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  const float t = fmaf(a.y, b.y, a.x * b.x);
  const float u = fmaf(a.w, b.w, a.z * b.z);
  return s + (t + u);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename TQ, typename TKV, int CV>
__global__ void __launch_bounds__(kMThreads, 1)
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
                          int tq, int tiles, int stage_pages, int slots,
                          float scale, int window, float softcap, bool wide) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr bool kF32 = std::is_same<TKV, float>::value;
  constexpr int E = Chunk<TKV>::E;                 // pool elements of 16 bytes
  constexpr int SWC = kRowLanes * 4 * CV;          // columns of a slice
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y;
  const int tile = (blockIdx.x / S) % tiles;
  const int b = blockIdx.x / S / tiles;
  const int G = H / K;
  const int t0 = tile * tq;
  const int nt = min(tq, T - t0);   // queries of this tile
  const int RT = tq * G;            // rows of the layout: r = i G + g for query t0 + i
  const int R = nt * G;             // rows with a query
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ig = tid / kRowLanes;   // this thread's rows: ig, ig + 16, ...
  const int jl = tid % kRowLanes;   // its tokens j, j + 16, ... and column chunks
  const int H_ = stage_pages;
  const MultiLayout L(RT, S, H_, slots, d, P, C, sizeof(TKV), SWC);
  const int dpad = L.dpad, ldk = L.ldk;

  extern __shared__ __align__(16) unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* kf = reinterpret_cast<float*>(smem + L.kf);
  float* vf = reinterpret_cast<float*>(smem + L.vf);
  unsigned char* raw = smem + L.raw;
  int* posb = reinterpret_cast<int*>(smem + L.pos);
  float* scl = reinterpret_cast<float*>(smem + L.scl);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* stm = reinterpret_cast<float*>(smem + L.stm);
  float* stl = reinterpret_cast<float*>(smem + L.stl);
  float* sta = reinterpret_cast<float*>(smem + L.sta);
  float* wts = reinterpret_cast<float*>(smem + L.wts);
  float* lsum = reinterpret_cast<float*>(smem + L.lsum);
  cluster_arrive();

  // row r of the tile is (query t0 + r / G, head kh G + r % G)
  auto row_offset = [&](int r) {
    const int i = r / G;
    return (((size_t)b * T + t0 + i) * H + (size_t)kh * G + (r - i * G)) * d;
  };

  // first round trip: this block's page ids (warp 0), q, q_pos (each warp
  // its tile's largest, each thread its rows')
  const int* tab = page_table + (size_t)b * C;
  if (tid < 32)
    for (int x = lane; rank + S * x < C; x += 32) ids[x] = min(max(tab[rank + S * x], 0), N - 1);
  constexpr int EQ = 16 / sizeof(TQ);  // q elements of 16 bytes
  if (d % EQ == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    // query i's G heads of kv head kh are G d contiguous elements, rows i G
    // .. i G + G - 1 of qs (dpad = d): up to 8 loads a thread in flight
    const TQ* qb = q + (((size_t)b * T + t0) * H + (size_t)kh * G) * d;
    const int gd = G * d;
    const int nch = R * d / EQ;
    for (int base = 0; base < nch; base += 8 * kMThreads) {
      uint4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = base + tid + k * kMThreads;
        if (j < nch) {
          const int i = j * EQ / gd;
          v[k] = __ldg(reinterpret_cast<const uint4*>(qb + (size_t)i * H * d + (j * EQ - i * gd)));
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = base + tid + k * kMThreads;
        if (j < nch) {
#pragma unroll
          for (int e = 0; e < EQ; e += 4)
            *reinterpret_cast<float4*>(qs + (size_t)j * EQ + e) = make_float4(
                elem<TQ>(v[k], e), elem<TQ>(v[k], e + 1), elem<TQ>(v[k], e + 2),
                elem<TQ>(v[k], e + 3));
        }
      }
    }
    for (int x = R * d + tid; x < RT * d; x += kMThreads) qs[x] = 0.f;
  } else {
    for (int x = tid; x < RT * dpad; x += kMThreads) {
      const int r = x / dpad;
      const int c = x - r * dpad;
      qs[x] = (r < R && c < d) ? to_f32(q[row_offset(r) + c]) : 0.f;
    }
  }
  const int* qp_row = q_pos + (size_t)b * T + t0;
  int qmax = -1;
  for (int x = lane; x < nt; x += 32) qmax = max(qmax, qp_row[x]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qmax = max(qmax, __shfl_xor_sync(kFull, qmax, o));
  int qpr[kRowsThread];
#pragma unroll
  for (int a = 0; a < kRowsThread; ++a) {
    const int r = ig + kRowGroups * a;
    qpr[a] = r < R ? qp_row[r / G] : -1;
  }
  __syncthreads();
  // live pages: min(C, the tile's largest q_pos // P + 1), page j to rank j mod S
  const int n_live = qmax < 0 ? 0 : min(C, qmax / P + 1);
  const int n_mine = rank < n_live ? (n_live - rank + S - 1) / S : 0;
  const int n_stages = (n_mine + H_ - 1) / H_;
  const int n_sl = (dpad + SWC - 1) / SWC;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const size_t ld = (size_t)K * d;  // pool row stride
  const int cr = wide ? d * static_cast<int>(sizeof(TKV)) / 16 : 0;  // 16-byte chunks a row

  // second round trip: every page of stage g into slot g % slots, issued in
  // one run (16-byte cp.async; byte by byte, converted, without WIDE rows)
  auto issue = [&](int g) {
    const int npg = min(H_, n_mine - g * H_);
    const int sb = (g % slots) * H_;
    if (wide) {
      for (int x = tid; x < npg * P; x += kMThreads) {
        const int pi = x / P;
        const int row = x - pi * P;
        repro::cp_async4(posb + (size_t)(sb + pi) * P + row,
                         pos_pages + (size_t)ids[g * H_ + pi] * P + row);
      }
      if constexpr (kInt8) {
        for (int x = tid; x < 2 * npg; x += kMThreads) {
          const size_t at = (size_t)ids[g * H_ + (x >> 1)] * K + kh;
          repro::cp_async4(scl + 2 * sb + x, (x & 1) ? v_scale + at : k_scale + at);
        }
      }
      for (int x = tid; x < 2 * P * cr; x += kMThreads) {  // (K or V, row, chunk) of a page
        const int c = x % cr;
        const int y = x / cr;
        const int row = y % P;
        const int which = y / P;
        for (int pi = 0; pi < npg; ++pi) {
          const TKV* src = (which ? v_pages : k_pages) +
                           ((size_t)ids[g * H_ + pi] * P + row) * ld + (size_t)kh * d + c * E;
          void* dst;
          if constexpr (kF32) {
            const size_t tok = (size_t)(sb + pi) * P + row;
            dst = which ? vf + tok * dpad + c * 4 : kf + tok * ldk + c * 4;
          } else {
            dst = raw + ((size_t)((sb + pi) * 2 + which) * P + row) * L.row_bytes + c * 16;
          }
          repro::cp_async16(dst, src);
        }
      }
    } else {
      for (int x = tid; x < npg * P; x += kMThreads) {
        const int pi = x / P;
        const int row = x - pi * P;
        posb[(size_t)(sb + pi) * P + row] = __ldg(pos_pages + (size_t)ids[g * H_ + pi] * P + row);
      }
      for (int x = tid; x < npg * 2 * P * dpad; x += kMThreads) {
        const int c = x % dpad;
        int y = x / dpad;
        const int row = y % P;
        y /= P;
        const int which = y & 1;
        const int pi = y >> 1;
        const int page = ids[g * H_ + pi];
        const size_t tok = (size_t)(sb + pi) * P + row;
        float v = 0.f;
        if (c < d) {
          const float s = kInt8 ? __ldg((which ? v_scale : k_scale) + (size_t)page * K + kh) : 1.f;
          v = staged((which ? v_pages : k_pages)[((size_t)page * P + row) * ld + (size_t)kh * d + c], s);
        }
        (which ? vf + tok * dpad : kf + tok * ldk)[c] = v;
      }
    }
    repro::cp_async_commit();
  };

  // bf16 / int8 pools: the raw bytes of slot g % slots into f32 (int8 bytes
  // times their page's scale, the reference's order)
  auto convert = [&](int g) {
    const int npg = min(H_, n_mine - g * H_);
    const int sb = (g % slots) * H_;
    for (int x = tid; x < 2 * P * cr; x += kMThreads) {
      const int c = x % cr;
      const int y = x / cr;
      const int row = y % P;
      const int which = y / P;
      for (int pi = 0; pi < npg; ++pi) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            raw + ((size_t)((sb + pi) * 2 + which) * P + row) * L.row_bytes + c * 16);
        const float s = kInt8 ? scl[2 * (sb + pi) + which] : 1.f;
        const size_t tok = (size_t)(sb + pi) * P + row;
        float* dst = (which ? vf + tok * dpad : kf + tok * ldk) + c * E;
#pragma unroll
        for (int k = 0; k < E / 4; ++k)
          *reinterpret_cast<float4*>(dst + 4 * k) = dequant4<TKV>(u, 4 * k, s);
      }
    }
  };

  for (int sl = 0; sl < n_sl; ++sl) {
    const int c0 = sl * SWC;  // the slice's first column
    float m[kRowsThread], l[kRowsThread], acc[kRowsThread][CV][4];
#pragma unroll
    for (int a = 0; a < kRowsThread; ++a) {
      m[a] = kNegInf;
      l[a] = 0.f;
#pragma unroll
      for (int cv = 0; cv < CV; ++cv)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][cv][e] = 0.f;
    }
    // the pages stay in shared memory across slices when one slot holds them
    const bool load = sl == 0 || n_stages > 1;
    int issued = 0;
    for (int g = 0; g < n_stages; ++g) {
      if (load) {
        // every stage the ring holds: g and g + 1 (slot (g + 1) % 2 was
        // freed by stage g - 1); one call site, so issue is inlined
        for (; issued < min(n_stages, g + 2); ++issued) issue(issued);
        if (issued > g + 1) {
          repro::cp_async_wait_group<1>();
        } else {
          repro::cp_async_wait_group<0>();
        }
        __syncthreads();
        if constexpr (!kF32) {
          if (wide) {
            convert(g);
            __syncthreads();
          }
        }
      }
      const int ntok = min(H_, n_mine - g * H_) * P;
      const size_t tb = (size_t)(g % slots) * H_ * P;  // the slot's first token
      for (int u0 = 0; u0 < ntok; u0 += kStepTok) {
        const int nstep = min(kStepTok, ntok - u0);
        // one step, specialised on TN, a thread's tokens (the step's tokens
        // over 16 lanes), so its loops are straight-line code
        auto step = [&](auto tn_c) {
          constexpr int TN = decltype(tn_c)::value;
          // scores: rows ig + 16 a against tokens u0 + jl + 16 t
          float s[kRowsThread][TN];
#pragma unroll
          for (int a = 0; a < kRowsThread; ++a)
#pragma unroll
            for (int t = 0; t < TN; ++t) s[a][t] = 0.f;
          const float* kb = kf + (tb + u0 + jl) * ldk;
#pragma unroll 2
          for (int c = 0; c < dpad; c += 4) {
            float4 kk[TN];
#pragma unroll
            for (int t = 0; t < TN; ++t)
              kk[t] = jl + kRowLanes * t < nstep
                          ? *reinterpret_cast<const float4*>(kb + (size_t)kRowLanes * t * ldk + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int a = 0; a < kRowsThread; ++a) {
              const int r = ig + kRowGroups * a;
              const float4 qq = r < RT ? *reinterpret_cast<const float4*>(qs + (size_t)r * dpad + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int t = 0; t < TN; ++t) s[a][t] = dot4(qq, kk[t], s[a][t]);
            }
          }
          int pt[TN];
#pragma unroll
          for (int t = 0; t < TN; ++t)
            pt[t] = jl + kRowLanes * t < nstep ? posb[tb + u0 + jl + kRowLanes * t] : -1;
          // online softmax a row, its max and sum over the 16 lanes that
          // share it; the rows' shuffles interleaved, level by level
          bool vis[kRowsThread][TN];
          float m_cur[kRowsThread], l_cur[kRowsThread];
#pragma unroll
          for (int a = 0; a < kRowsThread; ++a) {
            m_cur[a] = kNegInf;
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              vis[a][t] = pt[t] >= 0 && pt[t] <= qpr[a] && (window == 0 || qpr[a] - pt[t] < window);
              float x = s[a][t] * scale;
              if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
              s[a][t] = vis[a][t] ? x : kNegInf;
              m_cur[a] = fmaxf(m_cur[a], s[a][t]);
            }
          }
#pragma unroll
          for (int o = kRowLanes / 2; o > 0; o >>= 1)
#pragma unroll
            for (int a = 0; a < kRowsThread; ++a)
              m_cur[a] = fmaxf(m_cur[a], __shfl_xor_sync(kFull, m_cur[a], o));
#pragma unroll
          for (int a = 0; a < kRowsThread; ++a) {
            m_cur[a] = fmaxf(m[a], m_cur[a]);  // the row's new max
            l_cur[a] = 0.f;
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              // explicit p = 0 on masked entries: with every entry masked
              // the max stays kNegInf and exp(s - max) would be exp(0) = 1
              s[a][t] = vis[a][t] ? expf(s[a][t] - m_cur[a]) : 0.f;
              l_cur[a] += s[a][t];
            }
          }
#pragma unroll
          for (int o = kRowLanes / 2; o > 0; o >>= 1)
#pragma unroll
            for (int a = 0; a < kRowsThread; ++a)
              l_cur[a] += __shfl_xor_sync(kFull, l_cur[a], o);
#pragma unroll
          for (int a = 0; a < kRowsThread; ++a) {
            const int r = ig + kRowGroups * a;
            const float alpha = expf(m[a] - m_cur[a]);
            l[a] = alpha * l[a] + l_cur[a];
            m[a] = m_cur[a];
#pragma unroll
            for (int cv = 0; cv < CV; ++cv)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[a][cv][e] *= alpha;
            if (r < RT) {
#pragma unroll
              for (int t = 0; t < TN; ++t)
                if (jl + kRowLanes * t < nstep) ps[(size_t)r * kPsLd + jl + kRowLanes * t] = s[a][t];
            }
          }
        };
        switch ((nstep + kRowLanes - 1) / kRowLanes) {
          case 1: step(std::integral_constant<int, 1>{}); break;
          case 2: step(std::integral_constant<int, 2>{}); break;
          case 3: step(std::integral_constant<int, 3>{}); break;
          default: step(std::integral_constant<int, kTokThread>{}); break;
        }
        __syncthreads();  // the step's p
        // p . v: rows ig + 16 a, columns 4 (jl + 16 cv) of the slice
        const float* vb = vf + (tb + u0) * dpad + c0;
        int u = 0;
#pragma unroll 1
        for (; u + 4 <= nstep; u += 4) {
          float4 pp[kRowsThread];
#pragma unroll
          for (int a = 0; a < kRowsThread; ++a) {
            const int r = ig + kRowGroups * a;
            pp[a] = r < RT ? *reinterpret_cast<const float4*>(ps + (size_t)r * kPsLd + u)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int cv = 0; cv < CV; ++cv) {
              const int c = 4 * (jl + kRowLanes * cv);
              if (c0 + c < dpad) {
                const float4 vv = *reinterpret_cast<const float4*>(vb + (size_t)(u + k) * dpad + c);
#pragma unroll
                for (int a = 0; a < kRowsThread; ++a) fma4(acc[a][cv], comp(pp[a], k), vv);
              }
            }
        }
        for (; u < nstep; ++u) {
#pragma unroll
          for (int cv = 0; cv < CV; ++cv) {
            const int c = 4 * (jl + kRowLanes * cv);
            if (c0 + c < dpad) {
              const float4 vv = *reinterpret_cast<const float4*>(vb + (size_t)u * dpad + c);
#pragma unroll
              for (int a = 0; a < kRowsThread; ++a) {
                const int r = ig + kRowGroups * a;
                if (r < RT) fma4(acc[a][cv], ps[(size_t)r * kPsLd + u], vv);
              }
            }
          }
        }
        if (u0 + kStepTok < ntok) __syncthreads();  // the next step rewrites p
      }
      if (g + 2 < n_stages) __syncthreads();  // slot g % 2 is free for stage g + 2
    }

    // merge: row r goes to block rank r % S, which merges rows rank, rank +
    // S, ...; each block stores its (m, l, acc) of r into that block's
    // stage (distributed shared memory: stores do not wait for their round
    // trip), one cluster.sync publishes them
    if (sl == 0) cluster_wait();  // every block of the cluster runs
#pragma unroll
    for (int a = 0; a < kRowsThread; ++a) {
      const int r = ig + kRowGroups * a;
      if (r < RT) {
        const int owner = r % S;
        const size_t at = (size_t)rank * L.rs + r / S;
        float* dst = cluster.map_shared_rank(sta, owner) + at * L.sw;
#pragma unroll
        for (int cv = 0; cv < CV; ++cv) {
          const int c = 4 * (jl + kRowLanes * cv);
          if (c0 + c < dpad)
            *reinterpret_cast<float4*>(dst + c) =
                make_float4(acc[a][cv][0], acc[a][cv][1], acc[a][cv][2], acc[a][cv][3]);
        }
        if (jl == 0) {
          cluster.map_shared_rank(stm, owner)[at] = m[a];
          cluster.map_shared_rank(stl, owner)[at] = l[a];
        }
      }
    }
    cluster.sync();
    // this block's rows, the blocks merged in rank order: a state that saw
    // nothing (l = 0) weighs 0, never exp(0) = 1; the guarded divide gives
    // exact zeros where no block saw anything
    for (int sr = tid >> 5; sr < L.rs; sr += kMThreads / 32) {  // a warp a row
      if (rank + S * sr >= R) continue;
      // lane k < S holds block k's state: the largest m by shuffles, l
      // summed in rank order
      const bool live = lane < S;
      const float mk = live ? stm[lane * L.rs + sr] : kNegInf;
      const float lk = live ? stl[lane * L.rs + sr] : 0.f;
      float mt = mk;
#pragma unroll
      for (int o = kMaxSplits / 2; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float w = lk > 0.f ? expf(mk - mt) : 0.f;
      float lt = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k) lt += __shfl_sync(kFull, w * lk, k);
      if (live) wts[sr * S + lane] = w;
      if (lane == 0) lsum[sr] = lt;
    }
    __syncthreads();
    const int width = min(SWC, d - c0);
    for (int x = tid; x < L.rs * width; x += kMThreads) {
      const int sr = x / width;
      const int c = x - sr * width;
      const int r = rank + S * sr;
      if (r >= R) continue;
      float o = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < S) o += wts[sr * S + k] * sta[((size_t)k * L.rs + sr) * L.sw + c];
      out[row_offset(r) + c0 + c] = from_f32<TQ>(o / fmaxf(lsum[sr], 1e-30f));
    }
    // another slice rewrites every block's stage
    if (sl + 1 < n_sl) cluster.sync();
  }
}

// Launches B9 with plan p; returns the launch's error (a refused cluster
// launch included).
template <typename TQ, typename TKV, int CV>
cudaError_t launch_multi_cv(const void* q, const void* k, const void* v, const void* pos,
                            const void* table, const void* q_pos, const void* k_scale,
                            const void* v_scale, void* out, int B, int T, int H, int K, int d,
                            int N, int P, int C, const MultiPlan& p, float scale, int window,
                            float softcap, cudaStream_t s) {
  auto kernel = flash_decode_multi_kernel<TQ, TKV, CV>;
  // dynamic shared memory above 48 KB: opted in once an instance and device
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxDynSmem));
    if (e != cudaSuccess) return e;
    opted_in[dev].store(true, std::memory_order_relaxed);
  }
  const bool wide = (d * sizeof(TKV)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits * p.tiles * B, K, 1);
  cfg.blockDim = dim3(kMThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<TQ*>(out), T, H, K, d, N, P, C, p.tq, p.tiles, p.stage_pages, p.slots,
      scale, window, softcap, wide);
}

template <typename TQ, typename TKV>
cudaError_t launch_multi(const void* q, const void* k, const void* v, const void* pos,
                         const void* table, const void* q_pos, const void* k_scale,
                         const void* v_scale, void* out, int B, int T, int H, int K, int d,
                         int N, int P, int C, const MultiPlan& p, float scale, int window,
                         float softcap, cudaStream_t s) {
  return p.cv == 1
             ? launch_multi_cv<TQ, TKV, 1>(q, k, v, pos, table, q_pos, k_scale, v_scale, out, B,
                                           T, H, K, d, N, P, C, p, scale, window, softcap, s)
             : launch_multi_cv<TQ, TKV, 4>(q, k, v, pos, table, q_pos, k_scale, v_scale, out, B,
                                           T, H, K, d, N, P, C, p, scale, window, softcap, s);
}

inline int kv_bytes_of(int kv_dtype) { return kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1; }

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

// B9's plan for these shapes on the current device (multi_plan; kv_dtype
// as repro_flash_decode): plan[0..5] = tq, splits, tiles, stage_pages,
// slots, cv; returns the shared memory a block needs, or, where tq = 0 (the
// shape cannot be placed), what the smallest layout would need; minus the
// CUDA error where the device's SM count cannot be read.
extern "C" long long repro_flash_decode_multi_plan(int B, int K, int T, int G, int d, int P,
                                                   int C, int kv_dtype, int* plan) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  const MultiPlan p = multi_plan(B, K, T, G, d, P, C, kv_bytes_of(kv_dtype), sms);
  const int v[6] = {p.tq, p.splits, p.tiles, p.stage_pages, p.slots, p.cv};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return static_cast<long long>(p.smem);
}

// q (B, T, H, d), q_pos (B, T), out like q; dtypes and scales as
// repro_flash_decode.  tq and splits 0 take the plan's (else they force
// it: scripts/torch_decode_probe.py's sweep).  Returns the launch's error or
// cudaGetLastError() after it (0 on success); cudaErrorInvalidConfiguration,
// launching nothing, where the plan cannot place the shape.
extern "C" int repro_flash_decode_multi(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        const void* table, const void* q_pos,
                                        const void* k_scale,
                                        const void* v_scale,
                                        void* out, int B, int T, int H, int K,
                                        int d, int N, int P, int C,
                                        float scale, int window, float softcap,
                                        int tq, int splits, int q_dtype, int kv_dtype,
                                        void* stream) {
  if (tq < 0 || splits < 0 || splits > kMaxSplits || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const MultiPlan p =
      multi_plan(B, K, T, H / K, d, P, C, kv_bytes_of(kv_dtype), sms, tq, splits);
  if (p.tq == 0 || p.tq * (H / K) > kMaxRows) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_LAUNCH(TQ, TKV)                                                           \
  err = launch_multi<TQ, TKV>(q, k, v, pos, table, q_pos, k_scale, v_scale, out, B, T, H, \
                              K, d, N, P, C, p, scale, window, softcap, s)
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
