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
constexpr float kLog2e = 1.4426950408889634f;

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through
// registers; with ``in`` false nothing is read and the 16 bytes are
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// decode_split.cuh, attention_tile.cuh, flash_split.cuh, flash_mma.cuh)
// are templates over them, so a contiguous and a paged kernel run the
// same float code.  A 16-byte loader calls ``at`` once per key row it
// copies and adds its chunk offsets to the row start, so a paged map
// reads its page table once per row, never once per chunk.

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

// Whole caches, for kernels whose grid spans slots and KV heads:
// ``slot(b, kvh)`` gives that (slot, KV head)'s address map above.

// (B, S, KVH, D) through element strides (batch, seq, head).
template <typename T>
struct ContiguousCache {
  const T* k;
  const T* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  __device__ __forceinline__ ContiguousKV<T> slot(int b, int kvh) const {
    return {k + b * k_sb + kvh * k_sh, v + b * v_sb + kvh * v_sh, k_ss,
            v_ss};
  }
};

// Pools (P, ps, KVH, D) through element strides (page, offset, head) and
// a (B, NB) int32 page table: NB * ps positions per slot.
template <typename T>
struct PagedCache {
  const T* k;
  const T* v;
  const int* pages;
  int NB, ps;
  long long k_sp, k_ss, k_sh, v_sp, v_ss, v_sh;
  __device__ __forceinline__ PagedKV<T> slot(int b, int kvh) const {
    return {k + kvh * k_sh, v + kvh * v_sh,
            pages + static_cast<long long>(b) * NB, ps, k_sp, k_ss, v_sp,
            v_ss};
  }
};

}  // namespace repro
