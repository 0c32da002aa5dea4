// Paged single-query flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_kernel (pallas_call at decode_attention.py:264, reached through
// flash_decode() :193), float32 and bfloat16 pools:
//     out[b, h] = sum_t softmax_t(mask(softcap(scale * q[b, h] . k_t))) v_t
// over the tokens t stored in slot b's pages, for kv head h / G.
//
// What bounds it on the H100: device-memory bandwidth.  Each live K/V byte
// feeds 2 * G flops (the G query heads of one kv head share it): about 1.5
// flop/byte at G = 3 in float32, far below the ~295 flop/byte ridge.  The
// floor is the live K/V bytes (plus positions, q and out) over 3.35 TB/s.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

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
                    const int* __restrict__ q_pos, TQ* __restrict__ out,
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
    __syncthreads();  // the previous page's readers are done

    for (int i = tid; i < P * d; i += blockDim.x) {
      const int p = i / d;
      const int c = i - p * d;
      const size_t src = (((size_t)page * P + p) * K + kh) * d + c;
      ks[p * ldk + c] = to_f32(k_pages[src]);
      vs[i] = to_f32(v_pages[src]);
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
            const void* table, const void* q_pos, void* out, int B, int H,
            int K, int d, int N, int P, int C, float scale, int window,
            float softcap, size_t smem, cudaStream_t s) {
  const dim3 grid(B, K);
  flash_decode_kernel<TQ, TKV><<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<TQ*>(out), H, K, d, N, P, C, scale, window, softcap);
}

}  // namespace

// Shared memory one block needs, in bytes; the wrapper refuses shapes above
// the 48 KB a block gets without opting in.
extern "C" long long repro_flash_decode_smem_bytes(int G, int d, int P) {
  return static_cast<long long>(smem_words(G, d, P) * 4);
}

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16; out has q's dtype.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pos, const void* table,
                                  const void* q_pos, void* out, int B, int H,
                                  int K, int d, int N, int P, int C,
                                  float scale, int window, float softcap,
                                  int q_dtype, int kv_dtype, void* stream) {
  const size_t smem = smem_words(H / K, d, P) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                  \
  launch<TQ, TKV>(q, k, v, pos, table, q_pos, out, B, H, K, d, N, P, C, scale, \
                  window, softcap, smem, s)
  if (q_dtype == 0 && kv_dtype == 0) {
    REPRO_LAUNCH(float, float);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    REPRO_LAUNCH(float, __nv_bfloat16);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    REPRO_LAUNCH(__nv_bfloat16, float);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
