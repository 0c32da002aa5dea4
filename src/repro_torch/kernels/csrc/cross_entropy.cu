// Chunked softmax cross-entropy for Hopper (sm_90a): forward (B3) and
// backward (B4).
//
// B3 replaces the TPU kernel src/repro/kernels/cross_entropy.py::_ce_fwd_kernel
// (pallas_call at cross_entropy.py:89): per row of logits (N, V), an online
// logsumexp over the vocab plus the label logit gathered by a compare,
//     lse  = max + log(max(sum exp(x - max), 1e-30))
//     loss = lse - x[label]
// The TPU kernel walks vocab chunks along a sequential grid axis and carries
// the running max, denominator and label logit in VMEM scratch.
//
// B4 replaces src/repro/kernels/cross_entropy.py::_ce_bwd_kernel (pallas_call
// at cross_entropy.py:116):
//     dlogits = (exp(x - lse) - [col == label]) * g     per row,
// recomputed from the (N,) lse residual, so the (N, V) softmax is never kept.
//
// What bounds them on the H100: device-memory bandwidth.  B3 reads the
// logits once (N * V * itemsize bytes) for ~5 operations per element; B4
// reads them once and writes dlogits once.  Both sit far below the card's
// ~20 flop/byte float32 ridge.
//
// What the design does about it: B3 gives each row one block of 256
// threads.  The block's chunk of the vocab is its 256 threads wide; each
// thread strides through the row one chunk at a time (the ragged last chunk
// is masked by the loop bound, so any V works, unlike the TPU's V % block_v
// rule) keeping its own running max, running sum of exp and, where its
// column equals the label, the label logit — one pass over the row, one exp
// per element.  The (max, sum) pairs then merge by the same recurrence,
// first with warp shuffles and then across the 8 warps in shared memory, and
// thread 0 writes loss and lse.  Consecutive threads read consecutive
// columns, so every warp load is one 128-byte line.  B4 is elementwise and
// independent per element: a 2-D grid of (row, 1024-column chunk) blocks,
// each thread 4 columns apart by 256, no shared memory at all.  A row with
// g = 0 (a masked label) writes exact zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr float kNegInf = -2.3819763e38f;   // as the TPU kernel's NEG_INF
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBwdCols = 4 * kThreads;      // columns per B4 block

using repro::from_f32;
using repro::to_f32;

// merge the running (max, sum of exp(x - max)) pair (m2, l2) into (m, l)
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse, int V) {
  __shared__ float sm[kWarps], sl[kWarps], sp[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  const int lab = labels[row];
  float m = kNegInf, l = 0.f, picked = 0.f;
#pragma unroll 4
  for (int c = threadIdx.x; c < V; c += kThreads) {
    const float v = to_f32(xr[c]);
    if (v > m) {
      l = l * expf(m - v) + 1.f;
      m = v;
    } else {
      l += expf(v - m);
    }
    if (c == lab) picked = v;   // at most one hit in the whole row
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
    picked += __shfl_xor_sync(0xffffffffu, picked, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm[warp] = m;
    sl[warp] = l;
    sp[warp] = picked;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = sm[0], bl = sl[0], bp = sp[0];
    for (int w = 1; w < kWarps; ++w) {
      merge(bm, bl, sm[w], sl[w]);
      bp += sp[w];
    }
    const float s = bm + logf(fmaxf(bl, 1e-30f));
    lse[row] = s;
    loss[row] = s - bp;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dx, int V) {
  const long long row = blockIdx.x;
  const int lab = labels[row];
  const float s = lse[row];
  const float gr = g[row];
  const int c0 = blockIdx.y * kBwdCols;
  const int c1 = min(c0 + kBwdCols, V);
  const T* xr = x + row * V;
  T* dxr = dx + row * V;
#pragma unroll
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
    const float p = expf(to_f32(xr[c]) - s);
    dxr[c] = from_f32<T>((p - (c == lab ? 1.f : 0.f)) * gr);
  }
}

}  // namespace

// x: (N, V) logits, dtype 0 = float32, 1 = bfloat16; labels: (N,) int32 (a
// label outside [0, V) matches no column); loss, lse: (N,) float32.
extern "C" int repro_ce_fwd(const void* x, const void* labels, void* loss,
                            void* lse, int N, int V, int dtype, void* stream) {
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<N, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                lab, lo, ls, V);
  } else if (dtype == 1) {
    ce_fwd_kernel<__nv_bfloat16><<<N, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, lo, ls, V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dlogits (N, V) in x's dtype from x, labels, lse (N,) f32 and the loss
// cotangent g (N,) f32.
extern "C" int repro_ce_bwd(const void* x, const void* labels, const void* lse,
                            const void* g, void* dx, int N, int V, int dtype,
                            void* stream) {
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (V + kBwdCols - 1) / kBwdCols;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, chunks);
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 0) {
    ce_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), lab, ls, gg, static_cast<float*>(dx), V);
  } else if (dtype == 1) {
    ce_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, ls, gg,
        static_cast<__nv_bfloat16*>(dx), V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
