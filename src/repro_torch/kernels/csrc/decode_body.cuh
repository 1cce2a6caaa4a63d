// The per-(slot, KV head) body of one-token GQA decode attention,
// shared by the contiguous kernel (decode_attention.cu) and the paged
// kernel (paged_decode_attention.cu).
//
// The body is a template over an address map (common.cuh): ``kv.at(t)``
// gives position t's K and V head vectors for this CTA's (slot, KV
// head).  The two maps differ only in that address; every float
// operation, and its order, is the same code.  So the paged kernel
// returns bit for bit what the contiguous kernel returns on the same
// K/V values, for any permutation of the pages.
//
// Work split: 8 warps take positions round-robin, each keeps 4
// positions' loads in flight and runs its own (m, l, acc) online
// softmax in f32; the warps merge by log-sum-exp through shared
// memory.  Only positions 0..last are read.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeUnroll = 4;    // positions in flight per warp

// q: this row's G query heads, adjacent (G*D); o likewise.  Must be
// called by all kDecodeThreads threads of the CTA.
template <typename T, int G, int D, typename Map>
__device__ __forceinline__ void decode_rows(const T* __restrict__ qrow,
                                            const Map& kv, int last,
                                            T* __restrict__ orow,
                                            float scale) {
  constexpr int E = D / 32;         // elements of a head vector per lane
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = to_f32(qrow[g * D + lane * E + e]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp; t0 <= last; t0 += kDecodeWarps * kDecodeUnroll) {
    float kr[kDecodeUnroll][E], vr[kDecodeUnroll][E];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const int t = t0 + u * kDecodeWarps;
      if (t <= last) {
        const T *kp, *vp;
        kv.at(t, kp, vp);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[u][e] = to_f32(kp[lane * E + e]);
          vr[u][e] = to_f32(vp[lane * E + e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      if (t0 + u * kDecodeWarps > last) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[g][e] * kr[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float s = dot * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = alpha * l[g] + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states by log-sum-exp
  __shared__ float sm_m[kDecodeWarps][G];
  __shared__ float sm_l[kDecodeWarps][G];
  __shared__ float sm_acc[kDecodeWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kDecodeThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    orow[idx] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace repro
