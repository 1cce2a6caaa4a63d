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

// Address maps of a (slot, KV head)'s K and V rows: ``at(t, kp, vp)``
// points kp and vp at the first element of logical position t's K and
// V head vectors.  The attention bodies (decode_body.cuh,
// attention_tile.cuh) are templates over them, so a contiguous and a
// paged kernel run the same float code.

// Contiguous rows: position t sits at k + t * k_ss (and likewise v).
template <typename T>
struct ContiguousKV {
  const T* k;
  const T* v;
  long long k_ss, v_ss;
  __device__ __forceinline__ void at(int t, const T*& kp, const T*& vp) const {
    kp = k + t * k_ss;
    vp = v + t * v_ss;
  }
};

// Paged rows: position t sits in physical page table[t / ps], at offset
// t % ps; k and v already hold the KV-head offset.  One table read
// serves both K and V.
template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  const int* table;                 // this slot's row of the page table
  int ps;
  long long k_sp, k_ss, v_sp, v_ss; // element strides of page and offset
  __device__ __forceinline__ void at(int t, const T*& kp, const T*& vp) const {
    const int blk = t / ps;
    const int off = t - blk * ps;
    const long long page = __ldg(table + blk);
    kp = k + page * k_sp + off * k_ss;
    vp = v + page * v_sp + off * v_ss;
  }
};

}  // namespace repro
