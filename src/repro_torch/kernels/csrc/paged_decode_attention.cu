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
//   * the bodies are the contiguous kernel's (decode_split.cuh for
//     bf16, decode_body.cuh for float32), instantiated with a paged
//     address map (common.cuh) instead of a contiguous one.  The float
//     work and its order are identical, so the output is bit-identical
//     to decode_attention on the equivalent contiguous cache for any
//     page permutation (the reference promises the same), provided the
//     split layout is the same: the wrappers derive it from (B * KVH,
//     capacity, SM count), and a pool's capacity is NB * ps;
//   * bf16 takes the split-KV grid of (slot x KV head, split) CTAs and
//     the log-sum-exp merge, through paged_decode_attention_split_launch;
//     float32 the CUDA-core loop, one CTA per (slot, KV head), through
//     paged_decode_attention_launch;
//   * the pool is read in the model's own (P, ps, KVH, D) layout through
//     strides.  The reference's wrapper transposes the pool to
//     (KVH, P, ps, D) first, which in eager PyTorch would copy every
//     layer's whole pool on every step;
//   * there is no scalar prefetch on Hopper: each thread reads the table
//     entry of each key row it loads through __ldg, one int serving both
//     K and V;
//   * only positions up to pos are read (the split route zero-fills the
//     rows past it without reading), so pages past a slot's depth, and
//     the reserved garbage page 0 behind a retired slot's row, never are.

#include "decode_body.cuh"
#include "decode_split.cuh"

namespace {

using repro::kDecodeThreads;
using repro::PagedKV;

template <int G, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_attention_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ pages,
                              const int* __restrict__ pos,
                              float* __restrict__ o, int KVH, int NB, int ps,
                              long long k_sp, long long k_ss, long long k_sh,
                              long long v_sp, long long v_ss, long long v_sh,
                              float scale) {
  const int row = blockIdx.x;       // slot * KVH + kv head
  const int b = row / KVH;
  const int h = row - b * KVH;
  int last = pos[b];
  if (last > NB * ps - 1) last = NB * ps - 1;
  const int* table = pages + (long long)b * NB;
  const PagedKV<float> kv{k + h * k_sh, v + h * v_sh, table, ps,
                          k_sp, k_ss, v_sp, v_ss};
  repro::decode_rows<float, G, D>(q + (long long)row * G * D, kv, last,
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

template <int G, int D>
int launch_loop(const Args& a) {
  paged_decode_attention_kernel<G, D>
      <<<a.B * a.KVH, kDecodeThreads, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), a.pages, a.pos,
          static_cast<float*>(a.o), a.KVH, a.NB, a.ps, a.ks[0], a.ks[1],
          a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch_loop<1, D>(a);
    case 2: return launch_loop<2, D>(a);
    case 4: return launch_loop<4, D>(a);
    case 8: return launch_loop<8, D>(a);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// The CUDA-core loop, float32 only.  q, o: (B, KVH*G, D) contiguous; k,
// v: pools (P, ps, KVH, D) with unit stride on D and element strides
// (page, offset, head) given; pages: (B, NB) int32 contiguous; pos: (B,)
// int32 contiguous; scale is the contiguous kernel's 1/sqrt(D), passed
// the same way so that the two agree bit for bit.
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
  if (ps <= 0 || dtype != repro::kFloat32) return repro::kUnsupported;
  if (B <= 0 || NB <= 0) return 0;
  switch (D) {
    case 64: return dispatch_g<64>(G, a);
    case 96: return dispatch_g<96>(G, a);
    case 128: return dispatch_g<128>(G, a);
    default: return repro::kUnsupported;
  }
}

// The split-KV route, bfloat16 only: the same arguments as
// paged_decode_attention_launch, plus float32 scratch o_part (B * KVH,
// n_split, G, D) and ml_part (B * KVH, n_split, G, 2) and the split count
// and keys per split, with n_split * keys_per_split >= NB * ps.  Every row
// start of q and the pools 16-byte aligned.  Launches the split grid,
// then the merge grid.
extern "C" int paged_decode_attention_split_launch(
    const void* q, const void* k, const void* v, const void* pages,
    const void* pos, void* o, void* o_part, void* ml_part, int B, int KVH,
    int G, int D, int NB, int ps, long long k_sp, long long k_ss,
    long long k_sh, long long v_sp, long long v_ss, long long v_sh,
    int n_split, int keys_per_split, float scale, int dtype, void* stream) {
  if (ps <= 0 || dtype != repro::kBFloat16) return repro::kUnsupported;
  if (B <= 0 || NB <= 0) return 0;
  const repro::PagedCache<__nv_bfloat16> cache{
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pages),
      NB, ps, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh};
  return repro::decode_split::launch(
      G, D, q, cache, static_cast<const int*>(pos), 1, o, o_part, ml_part, B,
      NB * ps, KVH, n_split, keys_per_split, scale,
      static_cast<cudaStream_t>(stream));
}
