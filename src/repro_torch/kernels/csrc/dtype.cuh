// float32 / bfloat16 / int8 loads and stores shared by the port's kernels:
// every kernel computes in float32 whatever the storage type.  An int8 value
// converts to the float of the same integer; its scale is the caller's.
#pragma once
#include <cuda_bf16.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace repro
