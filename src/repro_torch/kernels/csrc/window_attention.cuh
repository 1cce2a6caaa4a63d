// The body both verify kernels instantiate (verify_attention.cu over a
// contiguous cache, paged_verify_attention.cu over pages): a T-token
// window of slot b at absolute positions pos[b] .. pos[b] + T - 1, where
// query head h attends to KV head h // G at positions <= pos[b] + t, up
// to the cache's capacity ``cap`` (S, or NB * ps for pages; a window
// that runs past it sees every key below it, the clamp the models' cache
// writes rely on).  Only the address map (``Cache``, common.cuh) differs
// between the two kernels, so on the same K/V values they return the
// same bits on every route.
//
// What bounds the work on the H100: at the speculative window (T 5, G 2,
// up to 2,048 cached rows) the bytes of K and V; at a prefix hit's suffix
// (T 200 behind 1,024 cached rows) flops and bytes about even.  Three
// routes, chosen by the Python wrappers (``_route``: dtype and the T * G
// rows that share a KV head):
//   * bf16, T * G <= 16: the split-KV kernel and log-sum-exp merge of
//     flash_split.cuh with the window start as the rows' position offset
//     (``launch_split``): the keys are spread over the card instead of
//     one CTA per (slot, KV head) walking them all;
//   * bf16, T * G > 16: the mma.sync tile kernel of flash_mma.cuh, one
//     CTA per (64-row window tile, slot, head), with the same offset
//     (``launch_tile``);
//   * float32: the CUDA-core tile loop of attention_tile.cuh through its
//     WindowRows row map (``window_tile_kernel``, ``launch_tile``), one
//     CTA per (32-row tile of the flattened (t, g) rows, slot, KV head).
#pragma once

#include <type_traits>

#include "attention_tile.cuh"
#include "flash_mma.cuh"
#include "flash_split.cuh"

namespace repro {
namespace window {

using bf16 = __nv_bfloat16;

template <typename T, int D, typename Cache>
__global__ void __launch_bounds__(kTileThreads)
window_tile_kernel(const T* __restrict__ q, Cache kv,
                   const int* __restrict__ pos, T* __restrict__ o, int Tw,
                   int cap, int KVH, int G, long long q_sb, long long q_ss,
                   long long q_sh, long long o_sb, long long o_ss,
                   long long o_sh, float scale) {
  const int r0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int n = Tw * G;
  const int p0 = pos[b];
  const WindowRows<T> rows{q + b * q_sb + kvh * G * q_sh,
                           o + b * o_sb + kvh * G * o_sh,
                           q_ss, q_sh, o_ss, o_sh, r0, G, n, p0};
  // the tile's last row sits at window row t_last
  const int t_last = (min(r0 + kBQ, n) - 1) / G;
  attend_tile<T, D>(rows, kv.slot(b, kvh), min(p0 + t_last + 1, cap),
                    scale);
}

// q, o: (B, Tw, H, D) with element strides qo = (q batch, seq, head, o
// batch, seq, head); pos: (B,) int32 window starts.  float32 runs the
// CUDA-core loop, bfloat16 the tensor-core tile kernel.
template <typename T, typename Cache>
int launch_tile(int D, const void* q, const Cache& kv, const int* pos,
                void* o, int B, int Tw, int cap, int H, int KVH,
                const long long* qo, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const T* qq = static_cast<const T*>(q);
  T* oo = static_cast<T*>(o);
  if constexpr (std::is_same_v<T, float>) {
    const dim3 grid((Tw * G + kBQ - 1) / kBQ, B * KVH);
    switch (D) {
      case 64:
        window_tile_kernel<T, 64, Cache><<<grid, kTileThreads, 0, stream>>>(
            qq, kv, pos, oo, Tw, cap, KVH, G, qo[0], qo[1], qo[2], qo[3],
            qo[4], qo[5], scale);
        break;
      case 96:
        window_tile_kernel<T, 96, Cache><<<grid, kTileThreads, 0, stream>>>(
            qq, kv, pos, oo, Tw, cap, KVH, G, qo[0], qo[1], qo[2], qo[3],
            qo[4], qo[5], scale);
        break;
      case 128:
        window_tile_kernel<T, 128, Cache><<<grid, kTileThreads, 0, stream>>>(
            qq, kv, pos, oo, Tw, cap, KVH, G, qo[0], qo[1], qo[2], qo[3],
            qo[4], qo[5], scale);
        break;
      default: return kUnsupported;
    }
    return static_cast<int>(cudaGetLastError());
  } else {
    switch (D) {
      case 64:
        return mma_tile::launch<64>(qq, kv, pos, oo, B, Tw, cap, H, G, qo,
                                    qo + 3, scale * kLog2e, true, stream);
      case 96:
        return mma_tile::launch<96>(qq, kv, pos, oo, B, Tw, cap, H, G, qo,
                                    qo + 3, scale * kLog2e, true, stream);
      case 128:
        return mma_tile::launch<128>(qq, kv, pos, oo, B, Tw, cap, H, G, qo,
                                     qo + 3, scale * kLog2e, true, stream);
      default: return kUnsupported;
    }
  }
}

// The split route (bfloat16): as ``launch_tile``, plus float32 scratch
// o_part (B * KVH, n_split, T * G, D) and ml_part (B * KVH, n_split,
// T * G, 2) and the split layout, with n_split * keys_per_split >= cap.
// Launches the split grid, then the merge grid.
template <typename Cache>
int launch_split(int D, const void* q, const Cache& kv, const int* pos,
                 void* o, void* o_part, void* ml_part, int B, int Tw,
                 int cap, int H, int KVH, const long long* qo, int n_split,
                 int keys_per_split, float scale, cudaStream_t stream) {
  const bf16* qq = static_cast<const bf16*>(q);
  bf16* oo = static_cast<bf16*>(o);
  float* op = static_cast<float*>(o_part);
  float* ml = static_cast<float*>(ml_part);
  switch (D) {
    case 64:
      return split_kv::launch<64>(qq, kv, pos, oo, op, ml, B, Tw, cap, H,
                                  KVH, qo, qo + 3, n_split, keys_per_split,
                                  scale * kLog2e, true, stream);
    case 96:
      return split_kv::launch<96>(qq, kv, pos, oo, op, ml, B, Tw, cap, H,
                                  KVH, qo, qo + 3, n_split, keys_per_split,
                                  scale * kLog2e, true, stream);
    case 128:
      return split_kv::launch<128>(qq, kv, pos, oo, op, ml, B, Tw, cap, H,
                                   KVH, qo, qo + 3, n_split, keys_per_split,
                                   scale * kLog2e, true, stream);
    default: return kUnsupported;
  }
}

}  // namespace window
}  // namespace repro
