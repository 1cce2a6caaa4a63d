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
// flops per byte in bf16 -- far below the ~295 flop/byte ridge.  K/V
// are read in the model's (B, S, KVH, D) layout through strides, so the
// wrapper never transposes the cache (in eager PyTorch that transpose
// would copy the whole cache per layer per step).  Two routes, chosen
// by the wrapper by dtype:
//   * bf16: the split-KV body of decode_split.cuh over the contiguous
//     cache map of common.cuh, through decode_attention_split_launch.
//     The Pallas kernel walks a (slot, KV head)'s KV blocks in one grid
//     row; here a grid of (slot x KV head, split) CTAs spreads every
//     slot's rows over the card (16 splits of 128 keys at 8 slots x 8
//     KV heads over 2,048 rows, from shapes alone), and a log-sum-exp
//     merge (split_merge.cuh) joins the splits;
//   * float32: the CUDA-core loop of decode_body.cuh, one CTA per (slot,
//     KV head), through decode_attention_launch.
// Both read only positions 0..pos of each slot.

#include "decode_body.cuh"
#include "decode_split.cuh"

namespace {

using repro::ContiguousKV;
using repro::kDecodeThreads;

template <int G, int D>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ pos, float* __restrict__ o,
                        int S, int KVH, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int pos_stride, float scale) {
  const int row = blockIdx.x;       // slot * KVH + kv head
  const int b = row / KVH;
  const int h = row - b * KVH;
  int last = pos[(long long)b * pos_stride];
  if (last > S - 1) last = S - 1;
  // q, o: (B, KVH*G, D) contiguous; this row's G heads are adjacent
  const ContiguousKV<float> kv{k + b * k_sb + h * k_sh,
                               v + b * v_sb + h * v_sh, k_ss, v_ss};
  repro::decode_rows<float, G, D>(q + (long long)row * G * D, kv, last,
                                  o + (long long)row * G * D, scale);
}

struct LoopArgs {
  const float *q, *k, *v;
  const int* pos;
  float* o;
  int B, S, KVH;
  const long long *ks, *vs;
  int pos_stride;
  float scale;
  cudaStream_t stream;
};

template <int G, int D>
int launch_loop(const LoopArgs& a) {
  decode_attention_kernel<G, D><<<a.B * a.KVH, kDecodeThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.pos, a.o, a.S, a.KVH, a.ks[0], a.ks[1], a.ks[2],
      a.vs[0], a.vs[1], a.vs[2], a.pos_stride, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_g(int G, const LoopArgs& a) {
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
// v: (B, S, KVH, D) with unit stride on D and element strides (batch,
// seq, head) given; pos: int32, read at pos[b * pos_stride] (pos_stride
// 0 broadcasts a scalar).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int S, int KVH, int G, int D, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int pos_stride, float scale, int dtype, void* stream) {
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  if (dtype != repro::kFloat32) return repro::kUnsupported;
  if (B <= 0 || S <= 0) return 0;
  const LoopArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<const int*>(pos),
                   static_cast<float*>(o), B, S, KVH, ks, vs, pos_stride,
                   scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64: return dispatch_g<64>(G, a);
    case 96: return dispatch_g<96>(G, a);
    case 128: return dispatch_g<128>(G, a);
    default: return repro::kUnsupported;
  }
}

// The split-KV route, bfloat16 only: the same arguments as
// decode_attention_launch, plus float32 scratch o_part (B * KVH, n_split,
// G, D) and ml_part (B * KVH, n_split, G, 2) and the split count and keys
// per split, with n_split * keys_per_split >= S.  Every row start of q,
// k and v 16-byte aligned.  Launches the split grid, then the merge grid.
extern "C" int decode_attention_split_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* o_part, void* ml_part, int B, int S, int KVH, int G, int D,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int pos_stride, int n_split,
    int keys_per_split, float scale, int dtype, void* stream) {
  if (dtype != repro::kBFloat16) return repro::kUnsupported;
  if (B <= 0 || S <= 0) return 0;
  const repro::ContiguousCache<__nv_bfloat16> cache{
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh};
  return repro::decode_split::launch(
      G, D, q, cache, static_cast<const int*>(pos), pos_stride, o, o_part,
      ml_part, B, S, KVH, n_split, keys_per_split, scale,
      static_cast<cudaStream_t>(stream));
}
