// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
