// W8A8 int8 GEMM on Hopper's warpgroup tensor-core products (wgmma.s8),
// fed by TMA through a ring of shared-memory stages: the int8_matmul
// route for every shape whose K and N are multiples of 16 (TMA's rule
// for row strides), the tiny keyword spotter's and the LM shapes
// included.  int8_matmul.cu's mma.sync kernel takes the other shapes.
//
// Replaces the TPU kernel
//   src/repro/kernels/int8_matmul/int8_matmul.py: int8_matmul_kernel
// and computes, as int8_matmul.cu's note says, bit for bit
//   out[m][n] = (float(sum_k x[m][k] * w[k][n]) * sx[m]) * sw[n]
// (an exact int32 sum, two __fmul_rn in that order, float32 or bf16 out).
//
// What bounds it on the H100: at the tiny keyword spotter's shape (M
// 12,544, K = N = 64, float32 out) bytes, ~4.1 MB (1.21 us at 3.35
// TB/s) against 0.1 GOP, so a call is set by its latency: the launch,
// one TMA round trip, one product and the stores; at a qwen3-1.7b FFN
// up-projection (M 1,024, K 2,048, N 6,144, bf16 out) operations, 25.8
// GOP (13.02 us at 1,979 dense int8 TOP/s).  The Pallas kernel keeps a
// 256 x 256 int32 accumulator in VMEM across a sequential K grid axis;
// here that axis is the ring each CTA walks, and the accumulator stays
// in the consumers' registers.
//
// Design (one CTA, 416 threads, per 128 x 128 output tile; K 128 bytes
// a stage through a ring of four; 192 KB of shared memory, one CTA an
// SM):
//   * warp roles: two consumer warpgroups (64 rows each), one transposer
//     warpgroup, one TMA warp.  The TMA warp's lane 0 keeps the ring
//     full: per stage it waits on the stage's `empty` barrier and starts
//     two TMA tile loads with the 128-byte swizzle, w (min(K, 128) k rows
//     x 128 N bytes, as the caller lays w out) on `wfull`, then x (128 x
//     128, K-major) on `xfull`; the first turn of the ring is started
//     before the other warps are released.  Past the tensor's edges TMA
//     fills zeros, which add nothing to the sums: ragged M, N and K need
//     no code.
//   * w's layout is the hard part: wgmma reads an operand transposed
//     (MN-major) only for 16-bit types, so for .s8 both A and B must be
//     K-major, and row-major (K, N) w is N-major.  The wrapper takes w as
//     the reference lays it out (no caller transposes it; the tiny path
//     quantizes w anew each call), so the transposer warpgroup waits on
//     `wfull` (while x is still landing), reads the raw tile, transposes
//     it 4 x 4 bytes at a time with __byte_perm and writes it K-major into
//     the 128-byte swizzle the wgmma descriptor names.  Each thread takes
//     a 16 (K) x 8 (N) block: thread t's n group (t % 8) and k chunk
//     ((t % 8) ^ (t / 16)) make both its 8-byte reads (raw chunk n-group ^
//     k % 8) and its 16-byte writes (transposed chunk k-chunk ^ n % 8)
//     fall in distinct banks across each phase; a block wholly past K or
//     N is skipped.  These are ordinary (generic-proxy) stores, and wgmma
//     reads through the async proxy, so every transposer thread runs
//     fence.proxy.async.shared::cta before it arrives on the stage's
//     `ready` barrier.  The raw slot is reused only after `empty`, which
//     the consumers reach after `ready`, so after the transposers have
//     read it.  Before the ring, the transposers stage the CTA's scales
//     (128 of sx, 128 of sw) in shared memory, two loads a thread in
//     flight at once.
//   * each consumer warpgroup waits on `xfull` and `ready`, starts four
//     wgmma.mma_async.m64n128k32.s32.s8.s8 (A and B from shared memory
//     through descriptors advanced 32 bytes along K), commits them, and
//     waits for the previous stage's group before it releases that stage
//     on `empty`: one group stays in flight.  No branch surrounds a
//     wgmma: ptxas serializes every product of a kernel where one does
//     (C7520).
//   * epilogue: each thread converts its 64 int32 sums and multiplies by
//     sx[m] then sw[n].  A CTA that walks more than one stage writes them
//     into the raw ring (64 rows x 128 bytes a slab, 128-byte swizzle,
//     conflict-free) and one thread a warpgroup starts TMA stores, which
//     clip at M and N; a CTA whose K fits one stage (the tiny shape)
//     stores straight from registers, where staging would be its longest
//     step.
//   * the TMA descriptors (x, w and, where K > 128, the output) are
//     encoded on the host for each call (hopper.cuh) and passed by value.
//
// Measured (chip_smoke.py phase 3, kernel-only by torch.profiler, NVIDIA
// H100 80GB HBM3 at 700.00 W): tiny 0.0038 ms (L2 cold 0.0043; the
// mma.sync route 0.0041, cold 0.0055); LM 0.0330-0.0332 ms (L2 cold
// 0.0358; the mma.sync route 0.1145; torch._int_mm alone 0.2076), 2.5x
// the bound.  At the LM shape the loads and shared memory set the pace
// (launch/int8_ablation.py, same card): with the transposes switched
// off the kernel takes 0.0263 ms, with the products off 0.0233-0.0258,
// with both and the stores off 0.0222 (0.0245 on a ring of three, 0.0302
// on two); each stage moves ~112 KB through shared memory (TMA writes,
// the transpose's read and write, the products' operand reads) for 2.1 M
// MACs.

#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace int8_wgmma {

constexpr int kBK = 128;                 // K bytes a stage
constexpr int kBN = 128;                 // output columns a CTA
constexpr int kWTile = kBK * kBN;        // raw w tile, and its transpose

constexpr int kBM = 128;                 // output rows a CTA
constexpr int kStages = 4;               // the ring
constexpr int kConsumers = 256;          // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 128 + 32;
constexpr int kXTile = kBM * kBK;
// the tiles, 1,024-byte aligned, then 4 barriers a stage and one for the
// scales, the scales (kBM of sx, kBN of sw), and the slack to align the
// dynamic shared memory's base
constexpr int kSmem = kStages * (kXTile + 2 * kWTile) +
                      (4 * kStages + 1) * 8 + (kBM + kBN) * 4 + 1024;
// a TMA-store epilogue stages each warpgroup's 64 x 128 float32 block in
// the raw ring
static_assert(kStages * kWTile >= kConsumers / 128 * 64 * kBN * 4,
              "raw ring");

// Four 16-byte columns of a transposed block: in[r] holds 4 N bytes of
// k row r (16 rows); column j (n % 8 = 4 side + j) gets k rows 0 .. 15
// of its n, written to row n of wt at chunk kc ^ (n % 8).
__device__ __forceinline__ void put_columns(const uint32_t (&in)[16],
                                            uint8_t* dst, int kc, int side) {
  // col[q][j]: k rows 4q .. 4q + 3 of column j
  uint32_t col[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t t0 = __byte_perm(in[4 * q], in[4 * q + 1], 0x5140);
    const uint32_t t1 = __byte_perm(in[4 * q], in[4 * q + 1], 0x7362);
    const uint32_t t2 = __byte_perm(in[4 * q + 2], in[4 * q + 3], 0x5140);
    const uint32_t t3 = __byte_perm(in[4 * q + 2], in[4 * q + 3], 0x7362);
    col[q][0] = __byte_perm(t0, t2, 0x5410);
    col[q][1] = __byte_perm(t0, t2, 0x7632);
    col[q][2] = __byte_perm(t1, t3, 0x5410);
    col[q][3] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * side + j;
    *reinterpret_cast<uint4*>(dst + c * kBK + ((kc ^ c) << 4)) =
        make_uint4(col[0][j], col[1][j], col[2][j], col[3][j]);
  }
}

// The transposer warpgroup's share of one stage: raw holds w's tile as
// TMA landed it (row k of 128 N bytes, 16-byte chunk c at c ^ (k % 8));
// wt gets it K-major (row n of 128 K bytes, chunk c at c ^ (n % 8)).
// Thread t takes 16 k rows (chunk kc) x 8 n columns (group grp, half).
// A block wholly past K or N is left as it is: the products read x's
// zero fill against its k rows, and its n columns are never stored.
__device__ __forceinline__ void transpose_tile(const uint8_t* raw,
                                               uint8_t* wt, int t,
                                               int k_left, int n_left) {
  const int grp = t & 7;                 // 16-column n group
  const int half = (t >> 3) & 1;         // its 8 columns
  const int kc = grp ^ (t >> 4);         // 16-row k chunk
  if (16 * kc >= k_left || 16 * grp + 8 * half >= n_left) return;
  uint32_t lo[16], hi[16];
  const uint8_t* src = raw + kc * 16 * kBN + half * 8;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        src + r * kBN + ((grp ^ (r & 7)) << 4));
    lo[r] = v.x;
    hi[r] = v.y;
  }
  uint8_t* dst = wt + (grp * 16 + half * 8) * kBK;
  put_columns(lo, dst, kc, 0);
  put_columns(hi, dst, kc, 1);
}

template <typename O>
__device__ __forceinline__ void store_pair(O* p, float v0, float v1);

template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0,
                                                  float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float v0,
                                                          float v1) {
  __nv_bfloat162 pair;
  pair.x = __float2bfloat16_rn(v0);
  pair.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = pair;
}

// The output staged for a TMA store: slabs of 64 rows x 128 bytes
// (32 float32 or 64 bf16 columns) in the 128-byte swizzle.  put_pair
// writes columns c, c + 1 of row r (r % 8 = g) of the warpgroup's 64 x
// 128 block; across a warp's store the 16-byte chunks c ^ g are
// distinct, so no bank is hit twice beyond the store's own width.
template <typename O>
__device__ __forceinline__ void put_pair(uint8_t* stage, int r, int c,
                                         float v0, float v1);

template <>
__device__ __forceinline__ void put_pair<float>(uint8_t* stage, int r,
                                                int c, float v0, float v1) {
  const int b = (c % 32) * 4;                    // byte in the slab row
  *reinterpret_cast<float2*>(stage + (c / 32) * 8192 + r * 128 +
                             (((b >> 4) ^ (r & 7)) << 4) + (b & 15)) =
      make_float2(v0, v1);
}

template <>
__device__ __forceinline__ void put_pair<__nv_bfloat16>(uint8_t* stage,
                                                        int r, int c,
                                                        float v0,
                                                        float v1) {
  __nv_bfloat162 pair;
  pair.x = __float2bfloat16_rn(v0);
  pair.y = __float2bfloat16_rn(v1);
  const int b = (c % 64) * 2;
  *reinterpret_cast<__nv_bfloat162*>(stage + (c / 64) * 8192 + r * 128 +
                                     (((b >> 4) ^ (r & 7)) << 4) +
                                     (b & 15)) = pair;
}

template <typename O>
__global__ void __launch_bounds__(kThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap to,
                  const float* __restrict__ sx,
                  const float* __restrict__ sw, O* __restrict__ out, int M,
                  int N, int K) {
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* xs = base;                          // S x-tiles
  uint8_t* raw = xs + S * kXTile;           // S raw w tiles
  uint8_t* wt = raw + S * kWTile;              // S transposed w tiles
  uint64_t* xfull = reinterpret_cast<uint64_t*>(wt + S * kWTile);
  uint64_t* wfull = xfull + S;
  uint64_t* ready = wfull + S;
  uint64_t* empty = ready + S;
  uint64_t* scaled = empty + S;
  float* scale = reinterpret_cast<float*>(scaled + 1);  // sx rows, sw cols

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nk = (K + kBK - 1) / kBK;
  // w's box holds min(K, 128) k rows (the descriptor's), so a K under a
  // stage moves no zero rows
  const int w_rows = K < kBK ? K : kBK;
  const int tid = threadIdx.x;
  // w first, on its own barrier, so its transpose overlaps x's arrival
  auto load_stage = [&](int kt) {
    const int s = kt % S;
    hopper::mbar_expect_tx(&wfull[s], w_rows * kBN);
    hopper::tma_load_2d(raw + s * kWTile, &tw, &wfull[s], n0, kt * kBK);
    hopper::mbar_expect_tx(&xfull[s], kXTile);
    hopper::tma_load_2d(xs + s * kXTile, &tx, &xfull[s], kt * kBK, m0);
  };

  if (tid == kConsumers + 128) {
    hopper::tma_prefetch(&tx);
    hopper::tma_prefetch(&tw);
    if (nk > 1) hopper::tma_prefetch(&to);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&xfull[s], 1);
      hopper::mbar_init(&wfull[s], 1);
      hopper::mbar_init(&ready[s], 128);
      hopper::mbar_init(&empty[s], kConsumers / 32);  // lane 0 of each warp
    }
    hopper::mbar_init(scaled, 128);
    hopper::mbar_init_fence();
    // the first turn of the ring needs no empty slot: start it before
    // the other threads are released
    for (int kt = 0; kt < nk && kt < S; ++kt) load_stage(kt);
  }
  __syncthreads();

  if (tid >= kConsumers + 128) {
    // the TMA warp: lane 0 keeps the ring full
    if (tid == kConsumers + 128) {
      for (int kt = S; kt < nk; ++kt) {
        hopper::mbar_wait(&empty[kt % S], ((kt / S) & 1) ^ 1);
        load_stage(kt);
      }
    }
  } else if (tid >= kConsumers) {
    // the transposer warpgroup: first the scales this CTA's epilogue
    // reads (0 past M and N), all loads in flight at once, then the ring
    const int t = tid - kConsumers;
    constexpr int kScales = kBM + kBN;     // at most 2 a thread
    float v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = t + 128 * q;
      v[q] = 0.f;
      if (i < kBM) {
        if (m0 + i < M) v[q] = sx[m0 + i];
      } else if (i < kScales && n0 + i - kBM < N) {
        v[q] = sw[n0 + i - kBM];
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (t + 128 * q < kScales) scale[t + 128 * q] = v[q];
    hopper::mbar_arrive(scaled);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      hopper::mbar_wait(&wfull[s], (kt / S) & 1);
      transpose_tile(raw + s * kWTile, wt + s * kWTile, t, K - kt * kBK,
                     N - n0);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[s]);
    }
  } else {
    // the consumer warpgroups
    const int wg = tid / 128;
    const int lane = tid % 32;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      const unsigned parity = (kt / S) & 1;
      hopper::mbar_wait(&xfull[s], parity);
      hopper::mbar_wait(&ready[s], parity);
      const uint64_t da = hopper::desc_k_major_sw128(
          xs + s * kXTile + wg * 64 * kBK);
      const uint64_t db = hopper::desc_k_major_sw128(wt + s * kWTile);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        hopper::wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      // the previous stage's products are done: release its slots
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % S]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // epilogue: row r = 16 (warp in group) + lane / 4 (+ 8) of the
    // warpgroup's 64, columns 8j + 2 (lane % 4) (+ 1)
    const int r = ((tid % 128) / 32) * 16 + lane / 4;
    const int c = 2 * (lane % 4);
    hopper::mbar_wait(scaled, 0);
    const float sxm[2] = {scale[wg * 64 + r], scale[wg * 64 + r + 8]};
    if (nk > 1) {
      // through shared memory (the raw ring, which nothing reads any
      // more) to TMA stores that clip at M and N: the stores leave at
      // once and overlap the next CTA's loads
      uint8_t* stage = raw + wg * 64 * kBN * static_cast<int>(sizeof(O));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float sw0 = scale[kBM + c + 8 * j];
        const float sw1 = scale[kBM + c + 8 * j + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v0 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), sxm[i]), sw0);
          const float v1 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), sxm[i]),
              sw1);
          put_pair<O>(stage, r + 8 * i, c + 8 * j, v0, v1);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + wg, 128);
      const int row0 = m0 + wg * 64;
      if (tid % 128 == 0 && row0 < M) {
        constexpr int kCols = 128 / static_cast<int>(sizeof(O));  // a slab
        for (int sl = 0; sl < kBN / kCols && n0 + sl * kCols < N; ++sl)
          hopper::tma_store_2d(&to, stage + sl * 8192, n0 + sl * kCols,
                               row0);
        hopper::tma_store_drain();
      }
    } else {
      // a CTA whose K fits one stage lives for one load, one product and
      // its stores, and staging would be its longest step: it stores
      // straight from registers, pairs of 8 (float32) or 4 (bf16) bytes
      // (a warp's store whole 32-byte sectors in float32; N is a
      // multiple of 16, so a pair n, n + 1 is whole)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + c + 8 * j;
        if (n >= N) continue;
        const float sw0 = scale[kBM + c + 8 * j];
        const float sw1 = scale[kBM + c + 8 * j + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + wg * 64 + r + 8 * i;
          if (m >= M) continue;
          const float v0 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), sxm[i]), sw0);
          const float v1 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), sxm[i]),
              sw1);
          store_pair<O>(out + static_cast<long long>(m) * N + n, v0, v1);
        }
      }
    }
  }
}

// The call's TMA descriptors: x, w and, where K > 128 (the kernel stores
// through TMA), the output.  Returns 0 or kTensorMapFailed.
template <typename O>
int encode_maps(const int8_t* x, const int8_t* w, void* out, int M, int N,
                int K, CUtensorMap* tx, CUtensorMap* tw, CUtensorMap* to) {
  constexpr int kOut = sizeof(O);
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (hopper::encode_2d(tx, u8, 1, x, M, K, kBM, kBK, sw128) ||
      hopper::encode_2d(tw, u8, 1, w, K, N, K < kBK ? K : kBK, kBN, sw128))
    return kTensorMapFailed;
  if (K > kBK &&
      hopper::encode_2d(to,
                        kOut == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        kOut, out, M, N, 64, 128 / kOut, sw128))
    return kTensorMapFailed;
  return 0;
}

template <typename O>
int launch(const int8_t* x, const int8_t* w, const float* sx,
           const float* sw, void* out, int M, int N, int K,
           cudaStream_t stream) {
  CUtensorMap tx, tw, to{};
  if (encode_maps<O>(x, w, out, M, N, K, &tx, &tw, &to))
    return kTensorMapFailed;
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      int8_wgmma_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8_wgmma_kernel<O><<<grid, kThreads, kSmem, stream>>>(
      tx, tw, to, sx, sw, static_cast<O*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8_wgmma
}  // namespace repro
