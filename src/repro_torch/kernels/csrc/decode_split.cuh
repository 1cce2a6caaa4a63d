// The split-KV body of one-token GQA decode attention (bf16), shared by
// the contiguous kernel (decode_attention.cu) and the paged kernel
// (paged_decode_attention.cu).
//
// What bounds decode on the H100 is the bytes of K and V: each (slot,
// KV head) reads its pos + 1 key and value rows once and does about G
// flops per byte.  At the serving shape (8 slots x 8 KV heads, G 2,
// D 128, up to 2,048 rows) that is ~30 MB, ~9 us at 3.35 TB/s, so the
// design is about keeping enough bytes in flight on every SM:
//   * grid (B * KVH, n_split): a CTA takes one contiguous range of
//     ``keys_per_split`` keys of its (slot, KV head), clipped to
//     min(pos[b], cap - 1); a range that starts past it writes m = -inf,
//     l = 0 and returns.  The wrappers pick the layout from (B * KVH,
//     capacity, SM count) alone, never from pos, so a deep slot is
//     spread over many CTAs instead of one CTA walking all its rows;
//   * K and V rows go to shared memory through a kStages-deep ring of
//     chunks of 16-byte cp.async copies, one address (page) lookup per
//     row a thread copies: the next chunks' bytes are in flight while
//     the current one is scored;
//   * a key row is read by a group of kLanes lanes (a power of two),
//     each taking kE adjacent columns: one 16-byte piece at D 64 (8
//     lanes) and D 128 (16 lanes); at D 96 a row's 12 pieces split into
//     no power of two of lanes, so 8 lanes take 24 bytes each, as three
//     8-byte reads.  A warp scores 32 / kLanes keys at once (2 at D 128,
//     4 at D 64 and 96) and a dot product is reduced in log2(kLanes)
//     shuffle steps; each group takes kPer keys of a chunk at once, so
//     their dot products and reductions are independent chains;
//   * the G queries live in f32 registers, pre-multiplied by scale *
//     log2(e); the softmax is online, in exp2, per query head, one
//     rescale per kPer keys; P V accumulates in registers (each lane its
//     kE columns); there is no shared-memory score matrix;
//   * at the CTA's end the groups of a warp merge by log-sum-exp through
//     shuffles, the warps through shared memory (the ring, no longer
//     needed), and the CTA writes its f32 partial (o, m, l), m in log2
//     units, in split_merge.cuh's layout; merge_splits_kernel is the
//     second launch.
// Only the cache map differs between the two kernels (common.cuh), so
// on the same K/V values they return the same bits.
#pragma once

#include <cmath>

#include "common.cuh"
#include "split_merge.cuh"

namespace repro {
namespace decode_split {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
// the most elements of K (and of V) a ring stage holds: 3 stages of K
// and V then fill the 48 KB a CTA gets without opting in
constexpr int kMaxStageElems = 4096;

template <int D>
struct Shape {
  static constexpr int kPieces = D / 8;           // 16-byte pieces a row
  // lanes per key row: a power of two, so that the shuffle reductions
  // stay inside a group
  static constexpr int kLanes = kPieces & (kPieces - 1) ? 8 : kPieces;
  static constexpr int kE = D / kLanes;           // columns per lane
  static constexpr int kGroups = 32 / kLanes;     // keys a warp scores at once
  // keys per stage: whole groups under kMaxStageElems (64 at D 64, 32 at
  // D 96 and 128)
  static constexpr int kChunk = kMaxStageElems / D / (kWarps * kGroups) *
                                (kWarps * kGroups);
  static constexpr int kStageElems = kChunk * D;
  static constexpr int kPer = kChunk / (kWarps * kGroups);  // keys per group
  static_assert(kLanes * kE == D && (kE == 8 || kE == 12), "whole lanes");
  static_assert(kPer >= 1, "a key per group");
  static_assert(kChunk * kPieces % kThreads == 0, "whole rounds of copies");
};

// N bf16 values (4 or 8: a uint2 or a uint4) to floats
template <int N, typename V>
__device__ __forceinline__ void unpack(const V& x, float* f) {
  static_assert(sizeof(V) == 2 * N, "N bf16 values");
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const float2 t = __bfloat1622float2(x2[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// a lane's kE columns at p as floats: one 16-byte read at kE 8, three
// 8-byte reads at kE 12 (p is then 8-byte aligned)
template <int kE>
__device__ __forceinline__ void load_cols(const bf16* p, float* f) {
  if constexpr (kE % 8 == 0) {
#pragma unroll
    for (int e = 0; e < kE / 8; ++e)
      unpack<8>(reinterpret_cast<const uint4*>(p)[e], f + 8 * e);
  } else {
#pragma unroll
    for (int e = 0; e < kE / 4; ++e)
      unpack<4>(reinterpret_cast<const uint2*>(p)[e], f + 4 * e);
  }
}

// q: (B, KVH * G, D) contiguous, the G heads of a (slot, KV head)
// adjacent; pos read at pos[b * pos_stride].  o_part (sets, n_split, G,
// D) and ml_part (sets, n_split, G, 2) float32.
template <int G, int D, typename Cache>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q, Cache kv,
                    const int* __restrict__ pos, int pos_stride,
                    float* __restrict__ o_part, float* __restrict__ ml_part,
                    int cap, int KVH, int keys_per_split, float scale_log2) {
  using S = Shape<D>;
  constexpr int kLanes = S::kLanes, kGroups = S::kGroups, kE = S::kE;
  constexpr int kChunk = S::kChunk, kPer = S::kPer, kPieces = S::kPieces;
  __shared__ __align__(16) bf16 ring[kStages][2][S::kStageElems];  // K, V

  const int set = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = set / KVH;
  const int kvh = set - b * KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLanes;                 // the warp's key group
  const int part = lane - grp * kLanes;          // columns part * kE ..
  const long long base = (static_cast<long long>(set) * n_split + split) * G;

  const int last = min(pos[static_cast<long long>(b) * pos_stride], cap - 1);
  const int k_begin = split * keys_per_split;
  const int k_stop = min(k_begin + keys_per_split, last + 1);
  if (k_begin >= k_stop) {                       // no visible key here
    if (tid < G) {
      ml_part[(base + tid) * 2] = -INFINITY;
      ml_part[(base + tid) * 2 + 1] = 0.f;
    }
    return;
  }
  const auto rows = kv.slot(b, kvh);
  const int n_chunks = (k_stop - k_begin + kChunk - 1) / kChunk;

  // stage st <- keys of chunk c; keys past k_stop are zero-filled
  auto load = [&](int c, int st) {
    const int c0 = k_begin + c * kChunk;
#pragma unroll
    for (int it = 0; it < kChunk * kPieces / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kPieces, piece = i - r * kPieces;
      const bool in = c0 + r < k_stop;
      const bf16 *kp, *vp;
      rows.at(in ? c0 + r : k_begin, kp, vp);
      cp_async16(&ring[st][0][r * D + piece * 8], kp + piece * 8, in);
      cp_async16(&ring[st][1][r * D + piece * 8], vp + piece * 8, in);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) load(st, st);
    cp_async_commit();
  }

  // this lane's kE columns of the G queries, times scale * log2(e)
  float qf[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_cols<kE>(q + (static_cast<long long>(set) * G + g) * D + part * kE,
                  qf[g]);
#pragma unroll
    for (int e = 0; e < kE; ++e) qf[g][e] *= scale_log2;
  }
  float m[G], l[G], acc[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();                // chunk c has landed
    __syncthreads();                             // and chunk c - 1 is done
    if (c + kStages - 1 < n_chunks)
      load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* ks = ring[c % kStages][0];
    const bf16* vs = ring[c % kStages][1];
    const int n_in = k_stop - (k_begin + c * kChunk);   // keys of the chunk

    // scores of this group's kPer keys j_u = u * kWarps * kGroups +
    // warp * kGroups + grp: a warp's groups read adjacent rows
    float sc[kPer][G];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = (u * kWarps + warp) * kGroups + grp;
      float kf[kE];
      load_cols<kE>(ks + j * D + part * kE, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) d += qf[g][e] * kf[e];
        sc[u][g] = d;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off >= 1; off >>= 1)
#pragma unroll
      for (int u = 0; u < kPer; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if ((u * kWarps + warp) * kGroups + grp >= n_in) {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[u][g] = -INFINITY;
      }
    }

    // online softmax per query head: one rescale for the kPer keys
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kPer; ++u) mx = fmaxf(mx, sc[u][g]);
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m[g] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        sc[u][g] = exp2f(sc[u][g] - m_use);     // now p
        sum += sc[u][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = (u * kWarps + warp) * kGroups + grp;
      float vf[kE];
      load_cols<kE>(vs + j * D + part * kE, vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] += sc[u][g] * vf[e];
    }
  }
  cp_async_wait<0>();

  // the warp's groups hold the same columns of different keys: merge
  // them by log-sum-exp through shuffles
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float a = exp2f(m[g] - m_use), w = exp2f(mo - m_use);
      l[g] = l[g] * a + lo * w;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * w;
      }
      m[g] = mx;
    }
  }

  // then the warps, through the ring: acc (kWarps, G, D), (m, l) (kWarps,
  // G, 2)
  __syncthreads();                               // every warp done reading
  float* acc_s = reinterpret_cast<float*>(&ring[0][0][0]);
  float* ml_s = acc_s + kWarps * G * D;
  static_assert((kWarps * G * D + kWarps * G * 2) * sizeof(float) <=
                    sizeof(bf16) * kStages * 2 * S::kStageElems,
                "the merge fits in the ring");
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc_s[(warp * G + g) * D + part * kE + e] = acc[g][e];
      if (part == 0) {
        ml_s[(warp * G + g) * 2] = m[g];
        ml_s[(warp * G + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * G + g) * 2]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(ml_s[(w * G + g) * 2] - m_use);
      o += c * acc_s[w * G * D + i];
      ls += c * ml_s[(w * G + g) * 2 + 1];
    }
    o_part[base * D + i] = o;
    if (i - g * D == 0) {
      ml_part[(base + g) * 2] = mx;
      ml_part[(base + g) * 2 + 1] = ls;
    }
  }
}

// the merge's output rows: (B, KVH * G, D) contiguous, row r of set
// (b, kvh) is head kvh * G + r
struct HeadRowsOut {
  bf16* o;
  int G, D;
  __device__ __forceinline__ bf16* at(int set, int r) const {
    return o + (static_cast<long long>(set) * G + r) * D;
  }
};

// a launch's arguments past the cache map
struct Args {
  const bf16* q;
  const int* pos;
  int pos_stride;
  bf16* o;
  float *o_part, *ml_part;
  int B, cap, KVH, n_split, keys_per_split;
  float scale_log2;
  cudaStream_t stream;
};

template <int G, int D, typename Cache>
int launch_gd(const Cache& kv, const Args& a) {
  decode_split_kernel<G, D, Cache>
      <<<dim3(a.B * a.KVH, a.n_split), kThreads, 0, a.stream>>>(
          a.q, kv, a.pos, a.pos_stride, a.o_part, a.ml_part, a.cap, a.KVH,
          a.keys_per_split, a.scale_log2);
  const HeadRowsOut out{a.o, G, D};
  merge_splits_kernel<bf16, HeadRowsOut>
      <<<dim3(a.B * a.KVH, G), D, merge_smem_bytes(a.n_split), a.stream>>>(
          a.o_part, a.ml_part, a.n_split, G, D, out);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Cache>
int launch_d(int G, const Cache& kv, const Args& a) {
  switch (G) {
    case 1: return launch_gd<1, D>(kv, a);
    case 2: return launch_gd<2, D>(kv, a);
    case 4: return launch_gd<4, D>(kv, a);
    case 8: return launch_gd<8, D>(kv, a);
    default: return kUnsupported;
  }
}

// q, o: (B, KVH * G, D) bf16 contiguous; keys through ``kv`` up to
// ``cap``; pos read at pos[b * pos_stride]; float32 scratch o_part (B *
// KVH, n_split, G, D) and ml_part (B * KVH, n_split, G, 2), with n_split
// * keys_per_split >= cap.  Launches the split grid, then the merge grid.
template <typename Cache>
int launch(int G, int D, const void* q, const Cache& kv, const int* pos,
           int pos_stride, void* o, void* o_part, void* ml_part, int B,
           int cap, int KVH, int n_split, int keys_per_split, float scale,
           cudaStream_t stream) {
  if (n_split <= 0 || n_split > kMaxSplits || keys_per_split <= 0 ||
      static_cast<long long>(n_split) * keys_per_split < cap)
    return kUnsupported;
  const Args a{static_cast<const bf16*>(q), pos, pos_stride,
               static_cast<bf16*>(o), static_cast<float*>(o_part),
               static_cast<float*>(ml_part), B, cap, KVH, n_split,
               keys_per_split, scale * kLog2e, stream};
  switch (D) {
    case 64: return launch_d<64>(G, kv, a);
    case 96: return launch_d<96>(G, kv, a);
    case 128: return launch_d<128>(G, kv, a);
    default: return kUnsupported;
  }
}

}  // namespace decode_split
}  // namespace repro
