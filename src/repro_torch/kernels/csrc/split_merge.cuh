// The second pass of a split-KV attention: merge each row's per-split
// partials by log-sum-exp.
//
// A first pass splits one row set's keys into n_split ranges and writes,
// per (row set, split, row), the unnormalised f32 output o_s (D values),
// the running max m_s of its scores in log2 units (scores times scale *
// log2(e)) and the sum l_s of exp2(score - m_s).  A split that saw no
// visible key carries m_s = -inf, l_s = 0 and o_s = 0, and weighs
// nothing here.  The merge is
//   M = max_s m_s,  w_s = exp2(m_s - M),
//   out = (sum_s w_s o_s) / max(sum_s w_s l_s, 1e-30),
// summed in split order by one thread per output element: deterministic,
// no atomics.  Scratch layout: o_part (sets, n_split, R, D) and ml_part
// (sets, n_split, R, 2) as (m, l), both contiguous float32.
//
// Used by flash attention's split route (flash_split.cuh); an output row
// map (``Out``: ``at(set, r)`` points at row r's first output element)
// adapts it to another caller's layout.
#pragma once

#include <cmath>

#include "common.cuh"

namespace repro {

// grid (sets, R), D threads: thread d merges element d of row r
template <typename T, typename Out>
__global__ void merge_splits_kernel(const float* __restrict__ o_part,
                                    const float* __restrict__ ml_part,
                                    int n_split, int R, int D, Out out) {
  const int set = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const long long row0 = static_cast<long long>(set) * n_split * R + r;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, ml_part[(row0 + s * R) * 2]);
  if (mx == -INFINITY) mx = 0.f;                 // no key at all: out 0
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long i = row0 + s * R;
    const float w = exp2f(ml_part[i * 2] - mx);
    den += w * ml_part[i * 2 + 1];
    num += w * o_part[i * D + d];
  }
  out.at(set, r)[d] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

}  // namespace repro
