// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel file exposes a plain C entry point (no PyTorch headers)
// that launches on the stream it is given and returns
// cudaGetLastError(), or kUnsupported for a shape/type it was not
// instantiated for.  The Python wrappers bind them with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kUnsupported = -1;
constexpr float kNegInf = -1e30f;   // the reference kernels' mask value

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro
