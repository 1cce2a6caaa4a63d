// The split-KV route of flash attention (bf16, at most 16 query rows per
// KV head): whisper's cross-attention at decode (Sq 1) and at prefill
// (Sq 4), and its decoder's 4-row causal self-attention at prefill.
//
// What bounds this work on the H100 is the bytes of K and V (a few query
// rows against every key), so the design spreads the keys over the card
// instead of one CTA walking them all:
//   * grid (batch * KV head, split): a CTA holds all R = G * Sq rows of
//     its (b, kvh) -- row r is (query t = r / G, head kvh * G + r % G),
//     at position t -- and streams one contiguous range of
//     ``keys_per_split`` keys through shared memory in 64-key chunks of
//     16-byte vector loads, so every K/V byte is read once per call;
//   * scores: thread (key j, row parity) dots its key's row against its
//     rows' f32 queries (pre-multiplied by scale * log2(e)); K rows are
//     padded by 16 bytes so a quarter-warp's 16-byte reads hit distinct
//     bank groups;
//   * an online softmax per row (one warp per row, f32, exp2), then
//     thread (d, row parity) accumulates its rows' P V in registers;
//   * it writes an f32 partial (o, m, l) per row to scratch; the second
//     grid (split_merge.cuh) merges the splits by log-sum-exp.  A split
//     whose keys are all masked (causal, past the last row) carries m =
//     -inf and l = 0 and weighs nothing: no NaN.
// The wrapper picks the split count so that the grid covers the 132 SMs
// several times (whisper: 96 (b, kvh) x 8 splits of 192 keys).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "split_merge.cuh"

namespace repro {
namespace split_kv {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;           // most rows a CTA holds (G * Sq)
constexpr int kChunk = 64;          // keys per shared-memory chunk
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, float* __restrict__ o_part,
                   float* __restrict__ ml_part, int Sq, int Skv, int KVH,
                   int G, int keys_per_split, long long q_sb,
                   long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, float scale_log2,
                   bool causal) {
  constexpr int kChunks = D / 8;    // 16-byte pieces per row
  constexpr int kKRow = D + 8;      // padded K row, elements
  constexpr int kRS = kThreads / D; // threads per output column (2 or 1)
  constexpr int kMine = kRows / kRS;  // rows a thread accumulates
  __shared__ float qs[kRows][D];
  __shared__ __align__(16) bf16 ks[kChunk][kKRow];
  __shared__ __align__(16) bf16 vs[kChunk][D];
  __shared__ float ps[kRows][kChunk + 1];
  __shared__ float m_s[kRows], l_s[kRows], a_s[kRows];

  const int set = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = set / KVH;
  const int kvh = set - b * KVH;
  const int R = G * Sq;
  const int tid = threadIdx.x;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r < R) {
      const int t = r / G;
      x = to_f32(q[b * q_sb + t * q_ss + (kvh * G + r - t * G) * q_sh + d]) *
          scale_log2;
    }
    qs[r][d] = x;
  }
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int k_begin = split * keys_per_split;
  int k_stop = min(Skv, k_begin + keys_per_split);
  if (causal) k_stop = min(k_stop, Sq);         // the last row is Sq - 1

  const int kj = tid % kChunk;                   // score role: key kj,
  const int kpar = tid / kChunk;                 // rows kpar, kpar + 2, ..
  const int dcol = tid % D;                      // P V role: column dcol,
  const int dpar = tid / D;                      // rows dpar + kRS i
  const int warp = tid >> 5, lane = tid & 31;
  float acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) acc[i] = 0.f;

  for (int c0 = k_begin; c0 < k_stop; c0 += kChunk) {
    __syncthreads();                             // previous chunk done
    for (int i = tid; i < kChunk * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (c0 + r < k_stop) {
        kx = __ldg(reinterpret_cast<const uint4*>(kb + (c0 + r) * k_ss) + c);
        vx = __ldg(reinterpret_cast<const uint4*>(vb + (c0 + r) * v_ss) + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c * 8]) = kx;
      *reinterpret_cast<uint4*>(&vs[r][c * 8]) = vx;
    }
    __syncthreads();

    // scores of key c0 + kj against rows kpar, kpar + 2, ...
    {
      float sc[kRows / 2];
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) sc[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        const uint4 kx = *reinterpret_cast<const uint4*>(&ks[kj][c * 8]);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&kx);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int r = kpar + 2 * i;
          if (r < R) {
#pragma unroll
            for (int e = 0; e < 8; ++e) sc[i] += qs[r][c * 8 + e] * kf[e];
          }
        }
      }
      const int key = c0 + kj;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = kpar + 2 * i;
        if (r < R) {
          const bool seen = key < k_stop && (!causal || key <= r / G);
          ps[r][kj] = seen ? sc[i] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < R; r += kWarps) {
      const float s0 = ps[r][lane], s1 = ps[r][lane + 32];
      const float m_old = m_s[r];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(s0 - m_use), p1 = exp2f(s1 - m_use);
      ps[r][lane] = p0;
      ps[r][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();                              // every lane read m_old
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc (rows dpar + kRS i, column dcol) = alpha acc + P V
    const int n_keys = min(kChunk, k_stop - c0);
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int r = dpar + kRS * i;
      if (r < R) acc[i] *= a_s[r];
    }
    for (int j = 0; j < n_keys; ++j) {
      const float vv = to_f32(vs[j][dcol]);
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int r = dpar + kRS * i;
        if (r < R) acc[i] += ps[r][j] * vv;
      }
    }
  }
  __syncthreads();                               // m_s, l_s final

  const long long base = (static_cast<long long>(set) * n_split + split) * R;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int r = dpar + kRS * i;
    if (r < R) o_part[(base + r) * D + dcol] = acc[i];
  }
  if (tid < R) {
    ml_part[(base + tid) * 2] = m_s[tid];
    ml_part[(base + tid) * 2 + 1] = l_s[tid];
  }
}

// flash's output rows for the merge: row r of set (b, kvh) is query t =
// r / G of head kvh * G + r % G
struct FlashOut {
  bf16* o;
  long long o_sb, o_ss, o_sh;
  int KVH, G;
  __device__ __forceinline__ bf16* at(int set, int r) const {
    const int b = set / KVH, kvh = set - b * KVH;
    const int t = r / G;
    return o + b * o_sb + t * o_ss + (kvh * G + r - t * G) * o_sh;
  }
};

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
           float* o_part, float* ml_part, int B, int Sq, int Skv, int H,
           int KVH, const long long* st, int n_split, int keys_per_split,
           float scale_log2, bool causal, cudaStream_t stream) {
  const int G = H / KVH;
  const int R = G * Sq;
  if (R > kRows || n_split <= 0 || keys_per_split <= 0 ||
      static_cast<long long>(n_split) * keys_per_split < Skv)
    return kUnsupported;
  flash_split_kernel<D><<<dim3(B * KVH, n_split), kThreads, 0, stream>>>(
      q, k, v, o_part, ml_part, Sq, Skv, KVH, G, keys_per_split, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2,
      causal);
  const FlashOut out{o, st[9], st[10], st[11], KVH, G};
  merge_splits_kernel<bf16, FlashOut>
      <<<dim3(B * KVH, R), D, 0, stream>>>(o_part, ml_part, n_split, R, D,
                                           out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split_kv
}  // namespace repro
