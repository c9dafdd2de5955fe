// Shared helpers of the port's Hopper kernels: dtype codes and fp32 <-> T
// conversions.  Every kernel computes in fp32 and stores in its input dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes passed over the C interface (kernels/_build.py: DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an fp32 value through T and back (where the reference casts)
template <typename T>
__device__ __forceinline__ float round_through(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace repro
