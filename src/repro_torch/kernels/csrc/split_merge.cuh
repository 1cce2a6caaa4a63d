// The second pass of a split-KV attention: merge each row's per-split
// partials by log-sum-exp.
//
// A first pass splits one row set's keys into n_split ranges and writes,
// per (row set, split, row), the unnormalised f32 output o_s (D values),
// the running max m_s of its scores in log2 units (scores times scale *
// log2(e)) and the sum l_s of exp2(score - m_s).  A split that saw no
// visible key carries m_s = -inf and l_s = 0, may leave o_s unwritten,
// and is skipped here.  The merge is
//   M = max_s m_s,  w_s = exp2(m_s - M),
//   out = (sum_s w_s o_s) / max(sum_s w_s l_s, 1e-30),
// summed in split order by one thread per output element: deterministic,
// no atomics.  Scratch layout: o_part (sets, n_split, R, D) and ml_part
// (sets, n_split, R, 2) as (m, l), both contiguous float32.
//
// Used by the split route of flash attention and of both verify kernels
// (flash_split.cuh); an output row map (``Out``: ``at(set, r)`` points at
// row r's first output element) adapts it to another caller's layout.
#pragma once

#include <cmath>

#include "common.cuh"

namespace repro {

// the most splits a merge takes: its (m, l) pairs fill 2 * kMaxSplits
// floats of shared memory, under the 48 KB a launch gets by default
constexpr int kMaxSplits = 4096;

__host__ __device__ constexpr int merge_smem_bytes(int n_split) {
  return 2 * n_split * static_cast<int>(sizeof(float));
}

// grid (sets, R), D threads, merge_smem_bytes(n_split) of dynamic shared
// memory: thread d merges element d of row r.  The block first stages
// every split's (m, l) of its row in shared memory, so that neither sum
// waits on a global read of them; each thread then sums in split order.
template <typename T, typename Out>
__global__ void merge_splits_kernel(const float* __restrict__ o_part,
                                    const float* __restrict__ ml_part,
                                    int n_split, int R, int D, Out out) {
  extern __shared__ float ml_s[];                // (n_split, 2) as (m, l)
  const int set = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const long long row0 = static_cast<long long>(set) * n_split * R + r;
  for (int s = d; s < n_split; s += blockDim.x) {
    ml_s[2 * s] = ml_part[(row0 + s * R) * 2];
    ml_s[2 * s + 1] = ml_part[(row0 + s * R) * 2 + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml_s[2 * s]);
  if (mx == -INFINITY) mx = 0.f;                 // no key at all: out 0
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    // read whatever an empty split left (it may have written no o) and
    // drop it, so that the loads of several splits can be in flight
    const float o = o_part[(row0 + s * R) * D + d];
    const float m = ml_s[2 * s];
    if (m == -INFINITY) continue;                // no key in this split
    const float w = exp2f(m - mx);
    den += w * ml_s[2 * s + 1];
    num += w * o;
  }
  out.at(set, r)[d] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

}  // namespace repro
