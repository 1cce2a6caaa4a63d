// Causal GQA flash attention, forward only, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_kernel (body _kernel), causal form
// and computes what it computes: query row i of head h attends to key
// rows j <= i of KV head h // G with an f32 online softmax over KV
// tiles, skipping tiles above the diagonal; out = acc / max(l, 1e-30).
//
// What bounds it on the H100: at prefill lengths (S = 128..1024, H 16,
// D 128) the bf16 tensor-core bound is operations (4096*S^2 flop vs
// 12288*S bytes at S = 1024).  This first version does NOT reach for
// the tensor cores: it is the simple, right kernel that later work
// makes fast (wgmma/mma.sync tiles, TMA loads, a K/V ring).  Its
// design choices:
//   * one CTA of 128 threads per (32-row query tile, batch*head); the
//     CTA streams 16-row K/V tiles through shared memory only up to the
//     diagonal (the reference skips the same blocks with pl.when);
//   * q/k/v/o are read and written in the model's (B, S, heads, D)
//   layout through strides: the wrapper neither transposes nor pads;
//   * the ragged tail is masked in the kernel: rows past Sq are never
//     stored, keys past Skv never score (the reference's wrapper pads
//     both to block multiples instead);
//   * each group of 4 threads owns one query row: its scores, its
//     (m, l) and a D/4 slice of its f32 accumulator stay in registers;
//     row max and row sum are two xor-shuffles inside the group.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;
using repro::to_f32;

constexpr int kBQ = 32;             // query rows per CTA
constexpr int kBK = 16;             // key rows per tile
constexpr int kThreads = 128;       // 4 threads per query row
constexpr int kCols = kBK / 4;      // score columns per thread

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int G, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long o_sb, long long o_ss,
                       long long o_sh, float scale) {
  constexpr int kJ = D / 4;         // accumulator slice per thread
  __shared__ float qs[kBQ][D + 1];
  __shared__ float ks[kBK][D + 1];
  __shared__ float vs[kBK][D];
  __shared__ float ps[kBQ][kBK + 1];

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int r = tid >> 2;           // this thread's query row in the tile
  const int sub = tid & 3;          // its quarter of the row

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    qs[rr][d] = (q0 + rr < Sq) ? to_f32(qb[(q0 + rr) * q_ss + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = 0.f;

  const int q_pos = q0 + r;
  // causal: the tile's last query row sees keys up to q0 + kBQ - 1
  const int k_end = min(Skv, q0 + kBQ);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                // previous tile fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, d = i - rr * D;
      const bool in = k0 + rr < Skv;
      ks[rr][d] = in ? to_f32(kb[(k0 + rr) * k_ss + d]) : 0.f;
      vs[rr][d] = in ? to_f32(vb[(k0 + rr) * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r][d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] += qv * ks[sub + 4 * c][d];
    }
    float mloc = kNegInf;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int k_pos = k0 + sub + 4 * c;
      s[c] = (k_pos <= q_pos && k_pos < Skv) ? s[c] * scale : kNegInf;
      mloc = fmaxf(mloc, s[c]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
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

  if (q_pos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + b * o_sb + (long long)q_pos * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < kJ; ++j) orow[sub + 4 * j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int G, const long long* st, float scale,
           cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, G, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Sq, int Skv, int H, int G, const long long* st,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, G, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, G, st, scale, stream);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, KVH, D), all with unit stride on
// D and element strides (batch, seq, head) given in that order for q,
// k, v, o.  Causal with both sequences starting at position 0.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int H, int KVH, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int dtype, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH) return repro::kUnsupported;
  if (B <= 0 || Sq <= 0) return 0;
  const int G = H / KVH;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, H, G, st, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, G, st, scale, s);
    default:
      return repro::kUnsupported;
  }
}
