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
// What bounds it on the H100: the larger of the causal-pair flops
// (4 * D per query head per visible key) and the K/V pages read once;
// at the suffix prefill's T = 200 behind a 1,024-token prefix the two
// are about even, near 2 us each.  This first version does not reach
// for the tensor cores.  Its design:
//   * the Pallas kernel holds all T * G query rows of a (slot, head) in
//     one block.  At T = 200 that is hundreds of rows for one CTA, so
//     here the window is tiled instead: one CTA per (32-row tile of the
//     window's T * G rows, slot, KV head).  Row r of the tile is window
//     row t = r / G of query head kvh * G + r % G (attention_tile.cuh's
//     WindowRows, shared with the contiguous verify kernel), so the G
//     heads that share a KV head share every K/V tile the CTA loads;
//   * the tile loop is attention_tile.cuh, the flash kernel's body,
//     with a query offset pos[b] and the paged address map of
//     common.cuh: each CTA streams its slot's pages from position 0 up
//     to pos[b] + t_last, the window position of its last row, and
//     masks k_pos <= pos[b] + t per row.  A window that crosses a page
//     boundary just reads both pages;
//   * the pool is read in the model's (P, ps, KVH, D) layout through
//     strides, q and o in (B, T, H, D): nothing is transposed or
//     padded, and garbage page 0 is never read.

#include "attention_tile.cuh"

namespace {

using repro::kBQ;
using repro::kTileThreads;
using repro::PagedKV;
using repro::WindowRows;

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
paged_verify_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pages, const int* __restrict__ pos,
    T* __restrict__ o, int Tw, int KVH, int G, int NB, int ps, long long q_sb,
    long long q_ss, long long q_sh, long long k_sp, long long k_ss,
    long long k_sh, long long v_sp, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale) {
  const int r0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int n = Tw * G;
  const int p0 = pos[b];
  const WindowRows<T> rows{q + b * q_sb + kvh * G * q_sh,
                           o + b * o_sb + kvh * G * o_sh,
                           q_ss, q_sh, o_ss, o_sh, r0, G, n, p0};
  const int* table = pages + (long long)b * NB;
  const PagedKV<T> kv{k + kvh * k_sh, v + kvh * v_sh, table, ps,
                      k_sp, k_ss, v_sp, v_ss};
  // the tile's last row sits at window row t_last
  const int t_last = (min(r0 + kBQ, n) - 1) / G;
  repro::attend_tile<T, D>(rows, kv, min(p0 + t_last + 1, NB * ps), scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pages,
           const int* pos, void* o, int B, int Tw, int KVH, int G, int NB,
           int ps, const long long* st, float scale, cudaStream_t stream) {
  dim3 grid((Tw * G + kBQ - 1) / kBQ, B * KVH);
  paged_verify_attention_kernel<T, D><<<grid, kTileThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pages, pos, static_cast<T*>(o), Tw, KVH, G,
      NB, ps, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* pages, const int* pos, void* o, int B, int Tw,
               int KVH, int G, int NB, int ps, const long long* st,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, pages, pos, o, B, Tw, KVH, G, NB, ps, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pages, pos, o, B, Tw, KVH, G, NB, ps, st, scale, stream);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// q, o: (B, T, H, D) with H = KVH * G; k, v: pools (P, ps, KVH, D); all
// with unit stride on D and element strides given in the order q (batch,
// seq, head), k (page, offset, head), v (page, offset, head), o (batch,
// seq, head).  pages: (B, NB) int32 contiguous; pos: (B,) int32
// contiguous, the window start of each slot.
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k, const void* v, const void* pages,
    const void* pos, void* o, int B, int Tw, int H, int KVH, int D, int NB,
    int ps, long long q_sb, long long q_ss, long long q_sh, long long k_sp,
    long long k_ss, long long k_sh, long long v_sp, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int dtype, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sp, k_ss, k_sh,
                            v_sp, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int* pg = static_cast<const int*>(pages);
  const int* ps_ = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH || ps <= 0) return repro::kUnsupported;
  if (B <= 0 || Tw <= 0 || NB <= 0) return 0;
  const int G = H / KVH;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, pg, ps_, o, B, Tw, KVH, G, NB, ps, st, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, pg, ps_, o, B, Tw, KVH, G, NB, ps, st, scale, s);
    default:
      return repro::kUnsupported;
  }
}
