// Multi-token GQA attention for a T-token window through a page table,
// for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:
//   paged_verify_attention_kernel (body _paged_verify_kernel)
// and computes what it computes: window row j of slot b (absolute
// position pos[b] + j) attends, for each query head h, to KV head
// h // G at positions <= pos[b] + j, where logical position t is row
// t % ps of physical page pages[b, t / ps] of the shared pool.  It
// serves the suffix prefill of a prefix-cache hit (T = the uncached
// suffix, tens to hundreds of tokens) and paged speculative verify
// (T = k + 1, down to 1).
//
// What bounds it on the H100: at the suffix prefill's T = 200 behind a
// 1,024-token prefix the causal-pair flops (4 * D per query head per
// visible key) and the K/V pages read once are about even, near 2 us
// each; at the speculative window the pages' bytes.  The body is
// window_attention.cuh, shared with the contiguous verify kernel, over
// the paged address map of common.cuh (one page-table read per key row
// a thread copies); the wrapper picks the route:
//   * bf16, T * G > 16 (the prefix hit's suffix): the mma.sync tile
//     kernel of flash_mma.cuh, one CTA per (64-row window tile, slot,
//     head), key tiles from 0 up to the tile's last row pos[b] + t,
//     through paged_verify_attention_launch.  The Pallas kernel holds
//     all T * G rows in one block and visits one page per grid step;
//   * bf16, T * G <= 16 (paged speculative verify): the split-KV kernel
//     of flash_split.cuh over the slot's NB * ps positions, through
//     paged_verify_attention_split_launch;
//   * float32: the CUDA-core tile loop of attention_tile.cuh with its
//     WindowRows row map, through paged_verify_attention_launch.
// A window that crosses a page boundary just reads both pages.  The pool
// is read in the model's (P, ps, KVH, D) layout through strides, q and o
// in (B, T, H, D): nothing is transposed or padded, and no position
// past a slot's window is read (keys there are zero-filled), so garbage
// page 0 never is.

#include "window_attention.cuh"

namespace {

template <typename T>
repro::PagedCache<T> cache(const void* k, const void* v, const void* pages,
                           int NB, int ps, const long long* st) {
  return {static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(pages), NB, ps,
          st[3], st[4], st[5], st[6], st[7], st[8]};
}

}  // namespace

// q, o: (B, T, H, D) with H = KVH * G; k, v: pools (P, ps, KVH, D); all
// with unit stride on D and element strides given in the order q (batch,
// seq, head), k (page, offset, head), v (page, offset, head), o (batch,
// seq, head).  pages: (B, NB) int32 contiguous; pos: (B,) int32
// contiguous, the window start of each slot.  float32 runs the CUDA-core
// loop, bfloat16 the tensor-core tile kernel (every row start 16-byte
// aligned).
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k, const void* v, const void* pages,
    const void* pos, void* o, int B, int Tw, int H, int KVH, int D, int NB,
    int ps, long long q_sb, long long q_ss, long long q_sh, long long k_sp,
    long long k_ss, long long k_sh, long long v_sp, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int dtype, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sp, k_ss, k_sh,
                            v_sp, v_ss, v_sh, o_sb, o_ss, o_sh};
  const long long qo[6] = {q_sb, q_ss, q_sh, o_sb, o_ss, o_sh};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH || ps <= 0) return repro::kUnsupported;
  if (B <= 0 || Tw <= 0 || NB <= 0) return 0;
  switch (dtype) {
    case repro::kFloat32:
      return repro::window::launch_tile<float>(
          D, q, cache<float>(k, v, pages, NB, ps, st), p, o, B, Tw, NB * ps,
          H, KVH, qo, scale, s);
    case repro::kBFloat16:
      return repro::window::launch_tile<__nv_bfloat16>(
          D, q, cache<__nv_bfloat16>(k, v, pages, NB, ps, st), p, o, B, Tw,
          NB * ps, H, KVH, qo, scale, s);
    default:
      return repro::kUnsupported;
  }
}

// The split-KV route, bfloat16 only, for T * G <= 16 rows per KV head:
// the same arguments as paged_verify_attention_launch, plus float32
// scratch o_part (B * KVH, n_split, T * G, D) and ml_part (B * KVH,
// n_split, T * G, 2) and the split count and keys per split, with
// n_split * keys_per_split >= NB * ps.  Launches the split grid, then
// the merge grid.
extern "C" int paged_verify_attention_split_launch(
    const void* q, const void* k, const void* v, const void* pages,
    const void* pos, void* o, void* o_part, void* ml_part, int B, int Tw,
    int H, int KVH, int D, int NB, int ps, long long q_sb, long long q_ss,
    long long q_sh, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int n_split, int keys_per_split,
    float scale, int dtype, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sp, k_ss, k_sh,
                            v_sp, v_ss, v_sh, o_sb, o_ss, o_sh};
  const long long qo[6] = {q_sb, q_ss, q_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH || ps <= 0 || dtype != repro::kBFloat16)
    return repro::kUnsupported;
  if (B <= 0 || Tw <= 0 || NB <= 0) return 0;
  return repro::window::launch_split(
      D, q, cache<__nv_bfloat16>(k, v, pages, NB, ps, st),
      static_cast<const int*>(pos), o, o_part, ml_part, B, Tw, NB * ps, H,
      KVH, qo, n_split, keys_per_split, scale, s);
}
