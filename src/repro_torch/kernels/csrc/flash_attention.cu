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
// The tile loop is attention_tile.cuh, shared with the paged verify
// kernel; this file supplies its row map (one head's query positions)
// and the contiguous K/V address map.

#include "attention_tile.cuh"

namespace {

using repro::ContiguousKV;
using repro::kBQ;
using repro::kTileThreads;

// Query rows q0..q0+kBQ-1 of one (batch, head), at positions 0..Sq-1.
template <typename T>
struct HeadRows {
  const T* q;                       // this (batch, head)'s row 0
  T* o;
  long long q_ss, o_ss;
  int q0, Sq;
  __device__ __forceinline__ bool valid(int rr) const { return q0 + rr < Sq; }
  __device__ __forceinline__ const T* qrow(int rr) const {
    return q + (q0 + rr) * q_ss;
  }
  __device__ __forceinline__ int q_pos(int rr) const { return q0 + rr; }
  __device__ __forceinline__ T* orow(int rr) const {
    return o + (q0 + rr) * o_ss;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int G, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long o_sb, long long o_ss,
                       long long o_sh, float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / G;
  const HeadRows<T> rows{q + b * q_sb + h * q_sh, o + b * o_sb + h * o_sh,
                         q_ss, o_ss, q0, Sq};
  const ContiguousKV<T> kv{k + b * k_sb + kvh * k_sh,
                          v + b * v_sb + kvh * v_sh, k_ss, v_ss};
  // causal: the tile's last query row sees keys up to q0 + kBQ - 1
  repro::attend_tile<T, D>(rows, kv, min(Skv, q0 + kBQ), scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int G, const long long* st, float scale,
           cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, D><<<grid, kTileThreads, 0, stream>>>(
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
