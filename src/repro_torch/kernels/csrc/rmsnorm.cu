// Fused RMSNorm for Hopper (sm_90a): forward (B1) and backward (B2).
//
// B1 replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call at rmsnorm.py:76, reached through rmsnorm() :133):
//     y = x * rsqrt(mean(x^2) + eps) * (1 + g)   per row, f32 accumulation.
//
// What bounds it on the H100: device-memory bandwidth.  Each element is read
// once and written once (2 * rows * D * itemsize bytes, plus the gain)
// against ~4 flops per element, far below the card's ~295 flop/byte ridge.
//
// What the design does about it: it spends nothing on tiling.  One warp owns
// one row, so the row's sum of squares is a register sum plus a five-step
// shuffle, with no shared memory and no __syncthreads.  The second pass
// re-reads the row it has just loaded, which hits L1/L2, so device-memory
// traffic stays one read and one write per element.  Lanes stride over the
// row, so any D works (576 is not a power of two).  The decode case (8 rows)
// runs 8 warps; large row counts fill the card with 4-warp blocks.  Where
// the TPU kernel zero-pads rows to its block, a warp past the last row here
// simply exits.
//
// B2 replaces src/repro/kernels/rmsnorm.py::_rmsnorm_bwd_kernel (pallas_call
// at rmsnorm.py:92, the custom_vjp backward at :117).  With
// r = rsqrt(mean(x^2) + eps):
//     dx    = r (1 + g) dy - x r^3 / D * sum_j dy_j (1 + g_j) x_j
//     dgain = sum_rows dy * x * r
// Like the TPU kernel it recomputes r from x instead of reading a residual.
//
// What bounds it: bandwidth again — x and dy are read once, dx written
// once (3 * rows * D * itemsize bytes), ~12 flops per element.
//
// What the design does about it: dx is B1's warp-per-row scheme (the row's
// sum of squares and its dy.(1+g).x dot product reduced together in
// registers and shuffles, then a second pass over the cached row).  dgain is
// the hard part: the TPU sums it across a *sequential* grid in VMEM, but GPU
// blocks run in no order.  Here a fixed number of blocks (at most a few per
// SM) each walk a fixed set of rows; every warp adds dy * x * r into its own
// row of shared memory (lanes own distinct columns, so no conflicts and no
// atomics), the block sums its warps in order into one row of an f32
// scratch (n_blocks, D) that the wrapper allocates, and a second small
// kernel sums that scratch's columns in block order.  The result is
// deterministic: the same inputs give the same bits.  The scratch costs
// 2 * n_blocks * D * 4 bytes of traffic, ~8% of the total at the training
// shape (4096 x 1024 f32).  The wrapper counts one B2 call per backward,
// although it takes these two launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
               T* __restrict__ y, int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)D + eps);

  for (int c = lane; c < D; c += 32) {
    yr[c] = from_f32<T>(to_f32(xr[c]) * r * (1.f + g[c]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); the gain is always float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* g, void* y, int rows,
                             int D, float eps, int dtype, void* stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(y), rows, D, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(y), rows, D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kBwdMaxWarps = 8;
constexpr int kBwdBlocksPerSM = 4;
constexpr int kSMs = 132;
constexpr int kMaxBwdSmem = 227 * 1024;

// warps per block: as many as fit 48 KB of per-warp dgain rows, at most 8
int bwd_warps(int D) {
  int w = (48 * 1024) / (D * (int)sizeof(float));
  return w < 1 ? 1 : (w > kBwdMaxWarps ? kBwdMaxWarps : w);
}

template <typename T>
__global__ void __launch_bounds__(kBwdMaxWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int D, float eps) {
  extern __shared__ float acc[];  // (warps, D): each warp's dgain sums
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* mine = acc + (size_t)warp * D;
  // a warp's row of acc is touched only by its own lanes (lane c owns
  // columns c, c + 32, ...) until the __syncthreads below
  for (int c = lane; c < D; c += 32) mine[c] = 0.f;

  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    T* dxr = dx + row * D;
    float ss = 0.f, dot = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xv = to_f32(xr[c]);
      ss += xv * xv;
      dot += to_f32(dyr[c]) * (1.f + g[c]) * xv;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    const float r = rsqrtf(ss / (float)D + eps);
    const float k = r * r * r / (float)D * dot;
    for (int c = lane; c < D; c += 32) {
      const float xv = to_f32(xr[c]);
      const float dyv = to_f32(dyr[c]);
      dxr[c] = from_f32<T>(r * ((1.f + g[c]) * dyv) - xv * k);
      mine[c] += dyv * xv * r;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += acc[(size_t)w * D + c];
    partial[(size_t)blockIdx.x * D + c] = s;
  }
}

// dgain[c] = sum over b of partial[b][c], in block order (deterministic)
__global__ void column_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int b = 0; b < n; ++b) s += partial[(size_t)b * D + c];
  out[c] = s;
}

template <typename T>
int launch_rmsnorm_bwd(const void* x, const void* g, const void* dy, void* dx,
                       void* dgain, void* partial, int n_blocks, int rows,
                       int D, float eps, cudaStream_t s) {
  const int warps = bwd_warps(D);
  const size_t smem = (size_t)warps * D * sizeof(float);
  if (smem > (size_t)kMaxBwdSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rmsnorm_bwd_kernel<T><<<n_blocks, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  column_sum_kernel<<<(D + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgain),
      n_blocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the f32 dgain scratch that repro_rmsnorm_bwd needs: one per block,
// at most kBwdBlocksPerSM blocks per SM, no more blocks than rows need.
extern "C" int repro_rmsnorm_bwd_blocks(int rows, int D) {
  const int warps = bwd_warps(D);
  const long long need = ((long long)rows + warps - 1) / warps;
  const long long cap = (long long)kBwdBlocksPerSM * kSMs;
  const long long n = need < cap ? need : cap;
  return n < 1 ? 1 : (int)n;
}

// dtype as repro_rmsnorm (x, dy and dx share it); g and dgain float32;
// partial is float32 (n_blocks, D) scratch, n_blocks from
// repro_rmsnorm_bwd_blocks.  Two launches; returns the first CUDA error.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* g, const void* dy,
                                 void* dx, void* dgain, void* partial,
                                 int n_blocks, int rows, int D, float eps,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_rmsnorm_bwd<float>(x, g, dy, dx, dgain, partial, n_blocks,
                                     rows, D, eps, s);
  if (dtype == 1)
    return launch_rmsnorm_bwd<__nv_bfloat16>(x, g, dy, dx, dgain, partial,
                                             n_blocks, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
