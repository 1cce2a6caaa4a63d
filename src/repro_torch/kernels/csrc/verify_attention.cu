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
// ~0.3 GFLOP of scores and products.  The body is window_attention.cuh,
// shared with the paged verify kernel, over the contiguous address map
// of common.cuh; the wrapper picks the route:
//   * bf16, T * G <= 16 (the speculative window: 10 rows): the split-KV
//     kernel of flash_split.cuh with the window start as the rows'
//     position offset, through verify_attention_split_launch.  The
//     Pallas kernel holds a (slot, KV head)'s rows in one block and
//     walks every key; here 8 slots x 8 KV heads x 16 splits of 128 keys
//     spread the 30 MB over the card, and a log-sum-exp merge joins the
//     splits.  The split layout depends on (B * KVH, S, SM count) only,
//     never on pos, which stays on the device;
//   * bf16, more rows: the mma.sync tile kernel of flash_mma.cuh with
//     the same offset, through verify_attention_launch;
//   * float32: the CUDA-core tile loop of attention_tile.cuh with its
//     WindowRows row map, through verify_attention_launch.
// q and o are read and written in the model's (B, T, H, D) layout and
// the cache in its (B, S, KVH, D) layout, all through strides: nothing
// is transposed or padded (the reference wrapper transposes the cache to
// (B*KVH, S, D) and pads S to its block).

#include "window_attention.cuh"

namespace {

template <typename T>
repro::ContiguousCache<T> cache(const void* k, const void* v,
                                const long long* st) {
  return {static_cast<const T*>(k), static_cast<const T*>(v),
          st[3], st[4], st[5], st[6], st[7], st[8]};
}

}  // namespace

// q, o: (B, T, H, D) with H = KVH * G; k, v: (B, S, KVH, D); all with
// unit stride on D and element strides (batch, seq, head) given in the
// order q, k, v, o.  pos: (B,) int32 contiguous, each slot's window
// start.  float32 runs the CUDA-core loop, bfloat16 the tensor-core tile
// kernel (every row start 16-byte aligned).
extern "C" int verify_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int Tw, int S, int H, int KVH, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int dtype,
    void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const long long qo[6] = {q_sb, q_ss, q_sh, o_sb, o_ss, o_sh};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH) return repro::kUnsupported;
  if (B <= 0 || Tw <= 0 || S <= 0) return 0;
  switch (dtype) {
    case repro::kFloat32:
      return repro::window::launch_tile<float>(
          D, q, cache<float>(k, v, st), p, o, B, Tw, S, H, KVH, qo, scale,
          s);
    case repro::kBFloat16:
      return repro::window::launch_tile<__nv_bfloat16>(
          D, q, cache<__nv_bfloat16>(k, v, st), p, o, B, Tw, S, H, KVH, qo,
          scale, s);
    default:
      return repro::kUnsupported;
  }
}

// The split-KV route, bfloat16 only, for T * G <= 16 rows per KV head:
// the same arguments as verify_attention_launch, plus float32 scratch
// o_part (B * KVH, n_split, T * G, D) and ml_part (B * KVH, n_split,
// T * G, 2) and the split count and keys per split, with n_split *
// keys_per_split >= S.  Launches the split grid, then the merge grid.
extern "C" int verify_attention_split_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* o_part, void* ml_part, int B, int Tw, int S, int H, int KVH,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int n_split, int keys_per_split, float scale, int dtype, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const long long qo[6] = {q_sb, q_ss, q_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH || dtype != repro::kBFloat16)
    return repro::kUnsupported;
  if (B <= 0 || Tw <= 0 || S <= 0) return 0;
  return repro::window::launch_split(
      D, q, cache<__nv_bfloat16>(k, v, st), static_cast<const int*>(pos), o,
      o_part, ml_part, B, Tw, S, H, KVH, qo, n_split, keys_per_split, scale,
      s);
}
