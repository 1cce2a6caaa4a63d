// GQA flash attention, forward only, causal or bidirectional, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_kernel (body _kernel), in both forms of its
//   ``causal`` switch
// and computes what it computes: query row i of head h attends to key
// rows j < Skv of KV head h // G -- only j <= i in the causal form --
// with an f32 online softmax over KV tiles; out = acc / max(l, 1e-30).
// The causal form skips tiles above the diagonal; the bidirectional
// form (an encoder's self-attention, a decoder's cross-attention, where
// Sq != Skv) streams every tile.  q rows sit at positions 0..Sq-1 and
// keys at 0..Skv-1 in both forms, as in the reference.
//
// What bounds it on the H100: at prefill lengths (S = 128..1500, H
// 12..16, D 64..128) the bf16 tensor-core bound is operations (4 D S^2
// flop per head vs ~4 D S bytes); at Sq = 1 (cross-attention of one
// decoded token) it is the bytes of K/V.  This first version does NOT
// reach for the tensor cores: it is the simple, right kernel that later
// work makes fast (wgmma/mma.sync tiles, TMA loads, a K/V ring; a
// split-KV grid for Sq = 1).  Its design choices:
//   * one CTA of 128 threads per (32-row query tile, batch*head); the
//     CTA streams 16-row K/V tiles through shared memory, in the causal
//     form only up to the diagonal (the reference skips the same blocks
//     with pl.when);
//   * q/k/v/o are read and written in the model's (B, S, heads, D)
//     layout through strides: the wrapper neither transposes nor pads,
//     so a strided per-layer view of a stacked cross K/V goes in as is;
//   * the ragged tail is masked in the kernel: rows past Sq are never
//     stored, keys past Skv never score (the reference's wrapper pads
//     both to block multiples instead, and takes no Skv % 128 != 0 in
//     the bidirectional form, e.g. whisper's 1,500 frames);
//   * each group of 4 threads owns one query row: its scores, its
//     (m, l) and a D/4 slice of its f32 accumulator stay in registers;
//     row max and row sum are two xor-shuffles inside the group.
// The tile loop is attention_tile.cuh, shared with the verify kernels;
// this file supplies its row map (one head's query positions; in the
// bidirectional form every row sits at Skv - 1, so it sees every key)
// and the contiguous K/V address map.  Key 0 stays visible to every
// row, the tile loop's invariant, whenever Skv >= 1.

#include "attention_tile.cuh"

namespace {

using repro::ContiguousKV;
using repro::kBQ;
using repro::kTileThreads;

// Query rows q0..q0+kBQ-1 of one (batch, head), at positions 0..Sq-1.
// The tile loop lets row rr see keys t <= q_pos(rr): its own position in
// the causal form, Skv - 1 (every key) in the bidirectional one.
template <typename T>
struct HeadRows {
  const T* q;                       // this (batch, head)'s row 0
  T* o;
  long long q_ss, o_ss;
  int q0, Sq, Skv;
  bool causal;
  __device__ __forceinline__ bool valid(int rr) const { return q0 + rr < Sq; }
  __device__ __forceinline__ const T* qrow(int rr) const {
    return q + (q0 + rr) * q_ss;
  }
  __device__ __forceinline__ int q_pos(int rr) const {
    return causal ? q0 + rr : Skv - 1;
  }
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
                       long long o_sh, float scale, bool causal) {
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / G;
  const HeadRows<T> rows{q + b * q_sb + h * q_sh, o + b * o_sb + h * o_sh,
                         q_ss, o_ss, q0, Sq, Skv, causal};
  const ContiguousKV<T> kv{k + b * k_sb + kvh * k_sh,
                          v + b * v_sb + kvh * v_sh, k_ss, v_ss};
  // causal: the tile's last query row sees keys up to q0 + kBQ - 1;
  // bidirectional: every row sees all Skv keys
  repro::attend_tile<T, D>(rows, kv, causal ? min(Skv, q0 + kBQ) : Skv,
                           scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int G, const long long* st, float scale,
           bool causal, cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, D><<<grid, kTileThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, G, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Sq, int Skv, int H, int G, const long long* st,
               float scale, bool causal, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, G, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, G, st, scale, causal, stream);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, KVH, D), all with unit stride on
// D and element strides (batch, seq, head) given in that order for q,
// k, v, o.  Both sequences start at position 0; ``causal`` != 0 lets
// query row i see keys j <= i, 0 every key j < Skv.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int H, int KVH, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int dtype,
    void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH || Skv <= 0) return repro::kUnsupported;
  if (B <= 0 || Sq <= 0) return 0;
  const int G = H / KVH;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, H, G, st, scale,
                               causal != 0, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, G, st,
                                       scale, causal != 0, s);
    default:
      return repro::kUnsupported;
  }
}
