// Shared helpers for the port's kernels: dtype codes, conversions, warp
// reductions. Every launcher has a plain C signature (loaded with ctypes)
// and returns cudaGetLastError() after its launch.
#pragma once
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

// dtype codes passed from Python (see kernels/*/ops.py)
enum ReproDtype { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Two neighbouring row elements from shared memory as f32 (4- or 8-byte load).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
