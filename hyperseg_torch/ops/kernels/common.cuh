// Device helpers shared by the kernels: bf16 <-> float32 by intrinsics only,
// activations in float32.
#pragma once

#include <cuda_bf16.h>

namespace hyperseg {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// Eval BN folded to y = x * scale + bias, in float32.
__device__ __forceinline__ float bn_scale(const float* w, const float* v, int c, float eps) {
  return w[c] * rsqrtf(v[c] + eps);
}

}  // namespace hyperseg
