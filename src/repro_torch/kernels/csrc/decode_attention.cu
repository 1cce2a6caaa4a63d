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
//     warps merge by log-sum-exp through shared memory at the end
//     (decode_body.cuh, shared with the paged kernel).
// Known limit, left for later work: 64 rows (8 slots x 8 KV heads) are
// fewer CTAs than the card's 132 SMs; a split-KV grid with an LSE merge
// across CTAs would fill it.

#include "decode_body.cuh"

namespace {

using repro::ContiguousKV;
using repro::kDecodeThreads;

template <typename T, int G, int D>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ o, int S, int KVH, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, int pos_stride,
                        float scale) {
  const int row = blockIdx.x;       // slot * KVH + kv head
  const int b = row / KVH;
  const int h = row - b * KVH;
  int last = pos[(long long)b * pos_stride];
  if (last > S - 1) last = S - 1;
  // q, o: (B, KVH*G, D) contiguous; this row's G heads are adjacent
  const ContiguousKV<T> kv{k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh,
                          k_ss, v_ss};
  repro::decode_rows<T, G, D>(q + (long long)row * G * D, kv, last,
                              o + (long long)row * G * D, scale);
}

template <typename T, int G, int D>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int B, int S, int KVH, const long long* ks,
           const long long* vs, int pos_stride, float scale,
           cudaStream_t stream) {
  decode_attention_kernel<T, G, D><<<B * KVH, kDecodeThreads, 0, stream>>>(
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
