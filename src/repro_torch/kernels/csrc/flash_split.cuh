// The split-KV route of attention (bf16, at most 16 query rows per KV
// head), shared by flash attention (whisper's cross-attention at decode,
// Sq 1, and at prefill, Sq 4, and its decoder's 4-row causal
// self-attention at prefill) and by both verify kernels (the speculative
// window: T 5, G 2, 10 rows).
//
// What bounds this work on the H100 is the bytes of K and V (a few query
// rows against every key), so the design spreads the keys over the card
// instead of one CTA walking them all:
//   * grid (batch * KV head, split): a CTA holds all R = G * Sq rows of
//     its (b, kvh) -- row r is (query t = r / G, head kvh * G + r % G),
//     at position off[b] + t (flash: off = 0; verify: off = pos[b], the
//     window start) -- and streams one contiguous range of
//     ``keys_per_split`` keys through shared memory in 64-key chunks of
//     16-byte cp.async copies (a whole chunk in flight at once), so every
//     K/V byte is read once per call.  The keys are reached through an
//     address map of common.cuh (``Cache``: contiguous rows or pages),
//     one row lookup per key row;
//   * the keys end at ``cap`` (flash: Skv; verify: the cache's S or the
//     pages' NB * ps), and in the causal form at min(cap, off[b] + Sq):
//     row r sees keys <= off[b] + r / G.  A split that starts past its
//     slot's last visible key writes m = -inf, l = 0 and returns;
//   * scores: thread (key j, row parity) dots its key's row against its
//     rows' f32 queries (pre-multiplied by scale * log2(e)), read 4 at a
//     time; K rows are padded by 16 bytes so a quarter-warp's 16-byte
//     reads hit distinct bank groups;
//   * an online softmax per row (one warp per row, f32, exp2), then
//     thread (d, row parity) accumulates its rows' P V in registers,
//     reading each row's P for 4 keys at a time.  With up to 16 rows
//     the loops are bound by shared-memory reads, not by flops: a
//     16-byte read feeds 4 FMAs where a scalar one fed 1;
//   * it writes an f32 partial (o, m, l) per row to scratch; the second
//     grid (split_merge.cuh) merges the splits by log-sum-exp.  A split
//     whose keys are all masked carries m = -inf and l = 0 and weighs
//     nothing: no NaN.
// The wrappers pick the split layout from (sets, cap, SM count) alone, so
// that the grid covers the 132 SMs several times (whisper: 96 (b, kvh) x
// 8 splits of 192 keys; verify at 8 slots x 8 KV heads over 2,048 rows:
// 16 splits of 128) and two calls on equal shapes split identically.
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

template <int D, typename Cache>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const bf16* __restrict__ q, Cache kv,
                   const int* __restrict__ off, float* __restrict__ o_part,
                   float* __restrict__ ml_part, int Sq, int cap, int KVH,
                   int G, int keys_per_split, long long q_sb,
                   long long q_ss, long long q_sh, float scale_log2,
                   bool causal) {
  constexpr int kChunks = D / 8;    // 16-byte pieces per row
  constexpr int kKRow = D + 8;      // padded K row, elements
  // threads per output column (2 at D 64, 1 at D 96 and 128): threads
  // kRS * D .. kThreads - 1 (32 at D 96) own no column
  constexpr int kRS = kThreads / D;
  constexpr int kMine = kRows / kRS;  // rows a thread accumulates
  static_assert(kRS >= 1 && kRows % kRS == 0, "whole rows a column");
  static_assert(kChunk * kChunks % kThreads == 0, "whole rounds of copies");
  // qs and ps are read 4 floats at a time (16-byte aligned rows)
  __shared__ __align__(16) float qs[kRows][D];
  __shared__ __align__(16) bf16 ks[kChunk][kKRow];
  __shared__ __align__(16) bf16 vs[kChunk][D];
  __shared__ __align__(16) float ps[kRows][kChunk + 4];
  __shared__ float m_s[kRows], l_s[kRows], a_s[kRows];

  const int set = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = set / KVH;
  const int kvh = set - b * KVH;
  const int R = G * Sq;
  const int tid = threadIdx.x;

  const int pos0 = off ? off[b] : 0;             // row r: pos0 + r / G
  const int k_begin = split * keys_per_split;
  int k_stop = min(cap, k_begin + keys_per_split);
  if (causal) k_stop = min(k_stop, pos0 + Sq);   // last row: pos0 + Sq - 1
  if (k_begin >= k_stop) {                       // no visible key here
    if (tid < R) {
      const long long i = (static_cast<long long>(set) * n_split + split) *
                              R + tid;
      ml_part[i * 2] = -INFINITY;
      ml_part[i * 2 + 1] = 0.f;
    }
    return;
  }
  const auto rows = kv.slot(b, kvh);

  // the query rows as 16-byte pieces, all in flight at once; rows past R
  // are zero
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const int t = r / G;
      x = __ldg(reinterpret_cast<const uint4*>(
                    q + b * q_sb + t * q_ss + (kvh * G + r - t * G) * q_sh) +
                c);
    }
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x2[e]);
      qs[r][c * 8 + 2 * e] = f.x * scale_log2;
      qs[r][c * 8 + 2 * e + 1] = f.y * scale_log2;
    }
  }
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int kj = tid % kChunk;                   // score role: key kj,
  const int kpar = tid / kChunk;                 // rows kpar, kpar + 2, ..
  const int dcol = tid % D;                      // P V role: column dcol,
  // rows dpar + kRS i; a thread past the columns gets rows past kRows,
  // so every ``r < R`` test below keeps it out
  const int dpar = tid < kRS * D ? tid / D : kRows;
  const int warp = tid >> 5, lane = tid & 31;
  float acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) acc[i] = 0.f;

  for (int c0 = k_begin; c0 < k_stop; c0 += kChunk) {
    __syncthreads();                             // previous chunk done
    // every 16-byte copy of the chunk in flight at once; keys past
    // k_stop are zero-filled.  Thread i copies chunk i % kChunks of its
    // rows: one address (page) lookup per row it touches
#pragma unroll
    for (int it = 0; it < kChunk * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i - r * kChunks;
      const bool in = c0 + r < k_stop;
      const bf16 *kp, *vp;
      rows.at(in ? c0 + r : k_begin, kp, vp);
      cp_async16(&ks[r][c * 8], kp + c * 8, in);
      cp_async16(&vs[r][c * 8], vp + c * 8, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
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
            const float4 qa = *reinterpret_cast<const float4*>(&qs[r][c * 8]);
            const float4 qb =
                *reinterpret_cast<const float4*>(&qs[r][c * 8 + 4]);
            sc[i] += qa.x * kf[0];
            sc[i] += qa.y * kf[1];
            sc[i] += qa.z * kf[2];
            sc[i] += qa.w * kf[3];
            sc[i] += qb.x * kf[4];
            sc[i] += qb.y * kf[5];
            sc[i] += qb.z * kf[6];
            sc[i] += qb.w * kf[7];
          }
        }
      }
      const int key = c0 + kj;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = kpar + 2 * i;
        if (r < R) {
          const bool seen =
              key < k_stop && (!causal || key <= pos0 + r / G);
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
    int j = 0;
    for (; j + 4 <= n_keys; j += 4) {            // 4 keys a step: each
      float vv[4];                               // row's 4 P values in
#pragma unroll                                   // one 16-byte read
      for (int u = 0; u < 4; ++u) vv[u] = to_f32(vs[j + u][dcol]);
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int r = dpar + kRS * i;
        if (r < R) {
          const float4 p = *reinterpret_cast<const float4*>(&ps[r][j]);
          acc[i] += p.x * vv[0];
          acc[i] += p.y * vv[1];
          acc[i] += p.z * vv[2];
          acc[i] += p.w * vv[3];
        }
      }
    }
    for (; j < n_keys; ++j) {
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

// the output rows for the merge, in the (B, Sq, H, D) layout of flash's
// and verify's outputs: row r of set (b, kvh) is query t = r / G of head
// kvh * G + r % G
struct SetRowsOut {
  bf16* o;
  long long o_sb, o_ss, o_sh;
  int KVH, G;
  __device__ __forceinline__ bf16* at(int set, int r) const {
    const int b = set / KVH, kvh = set - b * KVH;
    const int t = r / G;
    return o + b * o_sb + t * o_ss + (kvh * G + r - t * G) * o_sh;
  }
};

// q, o: (B, Sq, H, D) with element strides qs, os (batch, seq, head);
// keys through ``kv`` up to ``cap``; off: (B,) int32 position of each
// slot's query row 0, or null for 0.  Launches the split grid, then the
// merge grid.
template <int D, typename Cache>
int launch(const bf16* q, const Cache& kv, const int* off, bf16* o,
           float* o_part, float* ml_part, int B, int Sq, int cap, int H,
           int KVH, const long long* qs, const long long* os, int n_split,
           int keys_per_split, float scale_log2, bool causal,
           cudaStream_t stream) {
  const int G = H / KVH;
  const int R = G * Sq;
  if (R > kRows || n_split <= 0 || n_split > kMaxSplits ||
      keys_per_split <= 0 ||
      static_cast<long long>(n_split) * keys_per_split < cap)
    return kUnsupported;
  flash_split_kernel<D, Cache>
      <<<dim3(B * KVH, n_split), kThreads, 0, stream>>>(
          q, kv, off, o_part, ml_part, Sq, cap, KVH, G, keys_per_split,
          qs[0], qs[1], qs[2], scale_log2, causal);
  const SetRowsOut out{o, os[0], os[1], os[2], KVH, G};
  merge_splits_kernel<bf16, SetRowsOut>
      <<<dim3(B * KVH, R), D, merge_smem_bytes(n_split), stream>>>(
          o_part, ml_part, n_split, R, D, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split_kv
}  // namespace repro
