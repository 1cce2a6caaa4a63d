// One CTA's tile of multi-row attention with an f32 online softmax,
// shared by the causal flash kernel (flash_attention.cu) and the paged
// verify kernel (paged_verify_attention.cu).
//
// The CTA owns kBQ query rows.  A row map (``Rows``) says, for CTA-local
// row rr, whether it exists (``valid``), where its query and output
// vectors are (``qrow``, ``orow``) and at which absolute position it
// sits (``q_pos``); key rows are reached through an address map of
// common.cuh (``kv.at(t, kp, vp)``).  Row rr
// attends to key positions t <= q_pos(rr) with t < k_end.  The CTA
// streams kBK-row K/V tiles through shared memory from position 0 up to
// k_end; each group of 4 threads owns one query row: its scores, its
// (m, l) and a D/4 slice of its accumulator stay in registers, and row
// max and row sum are two xor-shuffles inside the group.
//
// Key 0 is visible to every row (q_pos >= 0), so each row's running
// max is a real score from the first tile on.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBQ = 32;             // query rows per CTA
constexpr int kBK = 16;             // key rows per tile
constexpr int kTileThreads = 128;   // 4 threads per query row
constexpr int kTileCols = kBK / 4;  // score columns per thread

template <typename T, int D, typename Rows, typename Map>
__device__ __forceinline__ void attend_tile(const Rows& rows, const Map& kv,
                                            int k_end, float scale) {
  constexpr int kJ = D / 4;         // accumulator slice per thread
  __shared__ float qs[kBQ][D + 1];
  __shared__ float ks[kBK][D + 1];
  __shared__ float vs[kBK][D];
  __shared__ float ps[kBQ][kBK + 1];
  __shared__ const T* krow[kBK];
  __shared__ const T* vrow[kBK];

  const int tid = threadIdx.x;
  const int r = tid >> 2;           // this thread's query row in the tile
  const int sub = tid & 3;          // its quarter of the row

  for (int i = tid; i < kBQ * D; i += kTileThreads) {
    const int rr = i / D, d = i - rr * D;
    qs[rr][d] = rows.valid(rr) ? to_f32(rows.qrow(rr)[d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = 0.f;

  const int q_pos = rows.q_pos(r);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                // previous tile fully consumed
    if (tid < kBK && k0 + tid < k_end) kv.at(k0 + tid, krow[tid], vrow[tid]);
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kTileThreads) {
      const int rr = i / D, d = i - rr * D;
      const bool in = k0 + rr < k_end;
      ks[rr][d] = in ? to_f32(krow[rr][d]) : 0.f;
      vs[rr][d] = in ? to_f32(vrow[rr][d]) : 0.f;
    }
    __syncthreads();

    float s[kTileCols];
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) s[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r][d];
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) s[c] += qv * ks[sub + 4 * c][d];
    }
    float mloc = kNegInf;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int k_pos = k0 + sub + 4 * c;
      s[c] = (k_pos <= q_pos && k_pos < k_end) ? s[c] * scale : kNegInf;
      mloc = fmaxf(mloc, s[c]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const float p = expf(s[c] - m_new);
      ps[r][sub + 4 * c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();                   // the row's 4 threads share one warp

#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] *= alpha;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r][c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[j] += p * vs[c][sub + 4 * j];
    }
  }

  if (rows.valid(r)) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = rows.orow(r);
#pragma unroll
    for (int j = 0; j < kJ; ++j) orow[sub + 4 * j] = from_f32<T>(acc[j] * inv);
  }
}

}  // namespace repro
