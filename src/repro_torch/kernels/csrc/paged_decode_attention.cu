// One-token GQA decode attention through a page table, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:
//   paged_decode_attention_kernel (body _paged_kernel)
// and computes what it computes: decode_attention_kernel's recurrence
// for every (slot, KV head) row, where logical position j of slot b is
// row j % ps of physical page pages[b, j / ps] of the shared pool.
//
// What bounds it on the H100: bytes, as for the contiguous kernel: the
// K/V vectors of positions 0..pos of every slot, read once, at about G
// flops per byte.  Its design:
//   * the body is decode_body.cuh, the same code as decode_attention.cu,
//     instantiated with a paged address map instead of a contiguous
//     one.  The float work and its order are identical, so the output
//     is bit-identical to decode_attention on the equivalent contiguous
//     cache for any page permutation (the reference promises the same);
//   * the pool is read in the model's own (P, ps, KVH, D) layout through
//     strides.  The reference's wrapper transposes the pool to
//     (KVH, P, ps, D) first, which in eager PyTorch would copy every
//     layer's whole pool on every step;
//   * there is no scalar prefetch on Hopper: each CTA reads its slot's
//     table row through __ldg, one int per position serving both K and
//     V, from L1;
//   * the CTA loops only up to pos, so pages past a slot's depth, and
//     the reserved garbage page 0 behind a retired slot's row, are
//     never read.
// Known limit, as for the contiguous kernel: B * KVH CTAs (64 at the
// main path's shape) leave most of the 132 SMs idle.

#include "decode_body.cuh"

namespace {

using repro::kDecodeThreads;
using repro::PagedKV;

template <typename T, int G, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ pages,
                              const int* __restrict__ pos,
                              T* __restrict__ o, int KVH, int NB, int ps,
                              long long k_sp, long long k_ss, long long k_sh,
                              long long v_sp, long long v_ss, long long v_sh,
                              float scale) {
  const int row = blockIdx.x;       // slot * KVH + kv head
  const int b = row / KVH;
  const int h = row - b * KVH;
  int last = pos[b];
  if (last > NB * ps - 1) last = NB * ps - 1;
  const int* table = pages + (long long)b * NB;
  const PagedKV<T> kv{k + h * k_sh, v + h * v_sh, table, ps,
                      k_sp, k_ss, v_sp, v_ss};
  repro::decode_rows<T, G, D>(q + (long long)row * G * D, kv, last,
                              o + (long long)row * G * D, scale);
}

struct Args {
  const void *q, *k, *v;
  const int *pages, *pos;
  void* o;
  int B, KVH, NB, ps;
  const long long *ks, *vs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int G, int D>
int launch(const Args& a) {
  paged_decode_attention_kernel<T, G, D>
      <<<a.B * a.KVH, kDecodeThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.pages, a.pos, static_cast<T*>(a.o),
          a.KVH, a.NB, a.ps, a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1],
          a.vs[2], a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, 1, D>(a);
    case 2: return launch<T, 2, D>(a);
    case 4: return launch<T, 4, D>(a);
    case 8: return launch<T, 8, D>(a);
    default: return repro::kUnsupported;
  }
}

template <typename T>
int dispatch_d(int G, int D, const Args& a) {
  switch (D) {
    case 64: return dispatch_g<T, 64>(G, a);
    case 128: return dispatch_g<T, 128>(G, a);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// q, o: (B, KVH*G, D) contiguous; k, v: pools (P, ps, KVH, D) with unit
// stride on D and element strides (page, offset, head) given; pages:
// (B, NB) int32 contiguous; pos: (B,) int32 contiguous; scale is the
// contiguous kernel's 1/sqrt(D), passed the same way so that the two
// agree bit for bit.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pages,
    const void* pos, void* o, int B, int KVH, int G, int D, int NB, int ps,
    long long k_sp, long long k_ss, long long k_sh, long long v_sp,
    long long v_ss, long long v_sh, float scale, int dtype, void* stream) {
  const long long ks[3] = {k_sp, k_ss, k_sh};
  const long long vs[3] = {v_sp, v_ss, v_sh};
  const Args a{q, k, v, static_cast<const int*>(pages),
               static_cast<const int*>(pos), o, B, KVH, NB, ps, ks, vs,
               scale, static_cast<cudaStream_t>(stream)};
  if (B <= 0 || NB <= 0) return 0;
  if (ps <= 0) return repro::kUnsupported;
  switch (dtype) {
    case repro::kFloat32: return dispatch_d<float>(G, D, a);
    case repro::kBFloat16: return dispatch_d<__nv_bfloat16>(G, D, a);
    default: return repro::kUnsupported;
  }
}
