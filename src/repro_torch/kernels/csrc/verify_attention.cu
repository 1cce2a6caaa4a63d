// Multi-token GQA attention for a T-token window against a contiguous
// KV cache (the speculative-decoding verify step), for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:
//   verify_attention_kernel (body _verify_kernel)
// and computes what it computes: window row j of slot b (absolute
// position pos[b] + j) attends, for each query head h, to KV head
// h // G at cache positions <= pos[b] + j -- causal inside the window,
// the whole committed prefix below it.  T = k + 1 (the last accepted
// token and k draft tokens); T = 1 is one-token decode.
//
// What bounds it on the H100: bytes.  At the serving shape (8 slots,
// T 5, KVH 8, G 2, D 128, up to 2,048 positions) each slot's K/V rows
// up to pos + T - 1 are read once, ~30 MB (~9 us at 3.35 TB/s), against
// ~0.3 GFLOP of scores and products.  This first version does not
// reach for the tensor cores.  Its design:
//   * the Pallas kernel holds all T * G query rows of a (slot, KV head)
//     in one block; here one CTA takes a 32-row tile of those rows, so
//     at T = 5, G = 2 the window's 10 rows are one tile and each of the
//     B * KVH CTAs streams its slot's K/V once, from position 0 up to
//     pos[b] + T - 1.  A longer window (T * G > 32) takes more tiles;
//   * the tile loop is attention_tile.cuh with its WindowRows row map
//     and the contiguous address map of common.cuh -- the paged verify
//     kernel runs the same loop and row map through its page table, so
//     on the same K/V values the two return the same bits;
//   * q and o are read and written in the model's (B, T, H, D) layout
//     and the cache in its (B, S, KVH, D) layout, all through strides:
//     nothing is transposed or padded (the reference wrapper transposes
//     the cache to (B*KVH, S, D) and pads S to its block).

#include "attention_tile.cuh"

namespace {

using repro::ContiguousKV;
using repro::kBQ;
using repro::kTileThreads;
using repro::WindowRows;

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
verify_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, T* __restrict__ o, int Tw, int S, int KVH,
    int G, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale) {
  const int r0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int n = Tw * G;
  const int p0 = pos[b];
  const WindowRows<T> rows{q + b * q_sb + kvh * G * q_sh,
                           o + b * o_sb + kvh * G * o_sh,
                           q_ss, q_sh, o_ss, o_sh, r0, G, n, p0};
  const ContiguousKV<T> kv{k + b * k_sb + kvh * k_sh,
                          v + b * v_sb + kvh * v_sh, k_ss, v_ss};
  // the tile's last row sits at window row t_last
  const int t_last = (min(r0 + kBQ, n) - 1) / G;
  repro::attend_tile<T, D>(rows, kv, min(p0 + t_last + 1, S), scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int B, int Tw, int S, int KVH, int G,
           const long long* st, float scale, cudaStream_t stream) {
  dim3 grid((Tw * G + kBQ - 1) / kBQ, B * KVH);
  verify_attention_kernel<T, D><<<grid, kTileThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), Tw, S, KVH, G,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* pos, void* o, int B, int Tw, int S, int KVH, int G,
               const long long* st, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, pos, o, B, Tw, S, KVH, G, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pos, o, B, Tw, S, KVH, G, st, scale, stream);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// q, o: (B, T, H, D) with H = KVH * G; k, v: (B, S, KVH, D); all with
// unit stride on D and element strides (batch, seq, head) given in the
// order q, k, v, o.  pos: (B,) int32 contiguous, each slot's window
// start.
extern "C" int verify_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int Tw, int S, int H, int KVH, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int dtype,
    void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH) return repro::kUnsupported;
  if (B <= 0 || Tw <= 0 || S <= 0) return 0;
  const int G = H / KVH;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, p, o, B, Tw, S, KVH, G, st, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, p, o, B, Tw, S, KVH, G, st, scale, s);
    default:
      return repro::kUnsupported;
  }
}
