// One-token GQA decode attention over a contiguous KV cache, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:
//   decode_attention_kernel (body _kernel)
// and computes what it computes: for every (slot, KV head) row, the G
// query heads of that KV head attend to cache positions 0..pos[slot]
// with an f32 online softmax; the result is acc / max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each row reads (pos+1) K and V
// vectors of D elements and does 4*G*D flops per position, about G
// flops per byte in bf16 -- far below the ~295 flop/byte ridge.  So
// the design is about reading the cache once and only as far as pos:
//   * one CTA per (slot, KV head); its G query heads share every K/V
//     read (the reference tiles G as the MXU row block for the same
//     reason);
//   * the CTA loops over positions 0..pos only: positions past a
//     slot's depth cost nothing (the reference skips whole KV blocks);
//   * K/V are read in the model's (B, S, KVH, D) layout through
//     strides, so the wrapper never transposes the cache (in eager
//     PyTorch that transpose would copy the whole cache per layer per
//     step);
//   * 8 warps split the positions round-robin, each warp keeps 4
//     positions' loads in flight, runs its own (m, l, acc), and the
//     warps merge by log-sum-exp through shared memory at the end.
// Known limit, left for later work: 64 rows (8 slots x 8 KV heads) are
// fewer CTAs than the card's 132 SMs; a split-KV grid with an LSE merge
// across CTAs would fill it.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;
using repro::to_f32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;          // positions in flight per warp

template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ o, int S, int KVH, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, int pos_stride,
                        float scale) {
  constexpr int E = D / 32;         // elements of a head vector per lane
  const int row = blockIdx.x;       // slot * KVH + kv head
  const int b = row / KVH;
  const int h = row - b * KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int last = pos[(long long)b * pos_stride];
  if (last > S - 1) last = S - 1;

  // q: (B, KVH*G, D) contiguous; this row's G heads are adjacent
  const T* qrow = q + (long long)row * G * D;
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

  const T* kb = k + b * k_sb + h * k_sh + lane * E;
  const T* vb = v + b * v_sb + h * v_sh + lane * E;
  for (int t0 = warp; t0 <= last; t0 += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kWarps;
      if (t <= last) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[u][e] = to_f32(kb[t * k_ss + e]);
          vr[u][e] = to_f32(vb[t * v_ss + e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u * kWarps > last) break;
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
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
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
  T* orow = o + (long long)row * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    orow[idx] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G, int D>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int B, int S, int KVH, const long long* ks,
           const long long* vs, int pos_stride, float scale,
           cudaStream_t stream) {
  decode_attention_kernel<T, G, D><<<B * KVH, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), S, KVH, ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], pos_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* pos, void* o, int B, int S, int KVH,
               const long long* ks, const long long* vs, int pos_stride,
               float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, 1, D>(q, k, v, pos, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    case 2: return launch<T, 2, D>(q, k, v, pos, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    case 4: return launch<T, 4, D>(q, k, v, pos, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    case 8: return launch<T, 8, D>(q, k, v, pos, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    default: return repro::kUnsupported;
  }
}

template <typename T>
int dispatch_d(int G, int D, const void* q, const void* k, const void* v,
               const int* pos, void* o, int B, int S, int KVH,
               const long long* ks, const long long* vs, int pos_stride,
               float scale, cudaStream_t st) {
  switch (D) {
    case 64: return dispatch_g<T, 64>(G, q, k, v, pos, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, pos, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// q, o: (B, KVH*G, D) contiguous; k, v: (B, S, KVH, D) with unit stride
// on D and element strides (batch, seq, head) given; pos: int32, read
// at pos[b * pos_stride] (pos_stride 0 broadcasts a scalar).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int S, int KVH, int G, int D, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int pos_stride, float scale, int dtype, void* stream) {
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(G, D, q, k, v, p, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(G, D, q, k, v, p, o, B, S, KVH, ks, vs, pos_stride, scale, st);
    default:
      return repro::kUnsupported;
  }
}
