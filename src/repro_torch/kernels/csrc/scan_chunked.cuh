// The chunked tensor-core route of the RWKV-6 scan (bf16 r, k, v), for
// sm_90a.
//
// For each (slot b, head h) and chunk of C steps, with c2 the inclusive
// cumulative sum of logw over the chunk in log2 units (c2 = log2(e) *
// clw), cp_t = c2_{t-1} (0 at the chunk's first step) and S_in the state
// carried in from the chunks before:
//   y_t    = (r_t o 2^cp_t) S_in + sum_{s<t} A[t,s] v_s + (sum_d r u k)_t v_t
//   A[t,s] = sum_d r_t,d k_s,d 2^(cp_t,d - c2_s,d)
//   S_out  = diag(2^c2_C) S_in + (k o 2^(c2_C - c2))^T v
// which is what the TPU kernel's chunked form computes
// (src/repro/kernels/linear_scan/linear_scan.py: _kernel).  Every exponent
// is <= 0 (logw <= 0, so c2 falls along the chunk), and no factor 2^(+x)
// is ever formed: the decays sum to hundreds within a chunk.
//
// What bounds it on the H100: bytes in principle (rwkv6-3b's prefill, B 1,
// T 1,024, H 48, dh 64: 38.5 MB read or written once, 11.5 us).  Only
// the state recurrence is sequential; a chunk's A and factors are not.
// So the work runs in two grids, and only the second walks the chunks:
//   * the intra-chunk grid, one CTA of 8 warps per (slot, head, chunk),
//     all in parallel, builds the chunk's A and factors and leaves, in
//     float32 scratch, y's chunk-local part A v, the carried part's
//     factor r o 2^cp, the state increment (k o 2^(c2_C - c2))^T v and
//     the decay 2^c2_C (~38 MB at the prefill shape, most of it read
//     back from L2);
//   * the carry grid, one CTA per (slot, head, kVB state columns), walks
//     the chunks in order: y = y_local + (r o 2^cp) S on the tensor
//     cores and S <- diag(2^c2_C) S + dS in float32, its inputs arriving
//     through a ring of cp.async stages that does not wait on the state.
// Inside a chunk:
//   * a chunk is NB = C / 16 sub-blocks with anchors B_i = c2 at the end
//     of sub-block i - 1 (B_0 = 0).  Off the diagonal (j < i), A's
//     16 x 16 block factors as
//       (r o 2^(cp - B_i)) diag(2^(B_i - B_{j+1})) (k o 2^(B_{j+1} - c2))^T
//     with every factor <= 1, on the tensor cores (mma.sync.m16n8k8 TF32,
//     f32 accumulators).  r and k are bf16 and exact in TF32; only the
//     decay-scaled factors round, at 2^-11;
//   * the diagonal 16 x 16 blocks go down the same way in halves: at
//     level l = 8, 4, 2 the lower half of each 2l-row group against its
//     upper half, through the anchor M = c2 at the upper half's last row,
//     (r o 2^(cp - M)) (k o 2^(M - c2))^T, one m16n8k8 product over d
//     whose fragments are built in registers (rows and columns of other
//     groups are computed and dropped); at level 1 (row 2m + 1 against
//     2m) the exponent is 0 exactly, so the entry is sum_d r k.  That is
//     one exp a row and level where the pairwise form took one a pair
//     (2.5x fewer), every product on the tensor cores, and still no
//     factor above 1.  A block's four tasks (levels 8, 2, 4, then 1 with
//     the bonus sum_d r u k on A's diagonal, so that y's chunk-local part
//     is one product A v) go to two or four warps;
//   * the same two factor matrices serve the sub-block level and the
//     products with the state: Qf = r o 2^(cp - B_i) (own sub-block's
//     start) and Kb = k o 2^(B_{j+1} - c2) (own sub-block's end); y's
//     carried factor is Qf diag(2^B_i) and the state increment
//     (Kb diag(2^(B_NB - B_{j+1})))^T v, each a product of factors <= 1;
//   * the state increment feeds the carried state, so its decayed k is
//     split into its TF32 value and the TF32 rounding of the rest (two
//     mma's, v exact): the state keeps float32 accuracy.  y's products
//     take TF32 operands once (y is rounded to bf16).  Rounding to TF32
//     is one integer add: the tensor cores read an operand's top 19 bits;
//   * each warp keeps several independent mma chains in flight (one per
//     n-tile or tile), so that the tensor cores' latency overlaps;
//   * the factors overwrite the chunk's raw tiles once the diagonal
//     blocks are done with them;
//   * the sequence may end anywhere: rows past T are zero-filled (r = k =
//     v = 0, logw = 0: the state passes them unchanged) and never stored.
//     Inputs are read through the model layout's (B, T, H, dh) strides.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {

// element strides (batch, time, head) of r, k, v, logw and y, each with
// unit stride on the head dim
struct ScanStrides {
  long long r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      w_sb, w_st, w_sh, y_sb, y_st, y_sh;
};

namespace scan_chunked {
// Internal linkage: the ``configured`` flag in ``launch`` is per library.
namespace {

using bf16 = __nv_bfloat16;

constexpr int kSub = 16;            // steps of a sub-block
// state columns a carry CTA walks: 32 (measured faster than 16, whose
// CTAs each read the whole r o 2^cp for half the work, and than 64,
// whose 48 CTAs at the prefill shape each do twice the work in order)
constexpr int kVB = 32;
constexpr int kPWarps = 8;          // the intra-chunk grid's warps
constexpr int kP = 32 * kPWarps;
constexpr int kQ = 128;             // the carry grid's threads

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (nearest, ties away) as the mma's operand bits: the
// tensor cores read the top 19 bits and ignore the low 13, so adding
// half of the last kept bit is the rounding (what cvt.rna.tf32.f32
// lowers to, less its test for infinities, which never occur here)
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x's TF32 value (the low 13 bits cleared) as a float
__device__ __forceinline__ float tf32_value(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 (8 bytes) as floats
__device__ __forceinline__ void ld4_bf16(const bf16* p, float (&x)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// one bf16 as the TF32 bits of its (exact) float value
__device__ __forceinline__ uint32_t bf16_bits(const bf16* p) {
  return __float_as_uint(__bfloat162float(*p));
}

// Steps of a chunk: 64, or 32 at D 128, so that an intra-chunk CTA holds
// as many values as at D 64.  ``linear_scan_chunked_steps`` hands it to
// the wrapper, which sizes the scratch by it.
template <int D>
__host__ __device__ constexpr int chunk_steps() {
  return D == 128 ? 32 : 64;
}

// Per (slot, head, chunk) the intra-chunk grid leaves, in float32: y's
// chunk-local part A v (C x D), the carried part's factor r o 2^cp
// (C x D), the chunk's state increment (k o 2^(c2_C - c2))^T v (D x D)
// and its decay 2^c2_C (D).
template <int D, int C>
__host__ __device__ constexpr long long chunk_floats() {
  return 2LL * C * D + static_cast<long long>(D) * D + D;
}

// Shared memory of an intra-chunk CTA (bytes): the chunk's raw tiles,
// c2 (logw, then its cumulative sum in place) | r | k, later overwritten
// by its factors Qf | Kb; v (all D columns); A; the scale vectors; the
// anchors; the cumulative sum's partials; u.
template <int D, int C>
struct IntraLayout {
  static constexpr int NB = C / kSub;
  static constexpr int NPAIR = NB * (NB - 1) / 2;
  static constexpr int LDF = D + 4;   // f32 rows (c2, Qf, Kb)
  static constexpr int LDH = D + 8;   // bf16 rows (r, k, v)
  static constexpr int LDA = C + 4;
  // scale vectors: 2^B_i (i < NB), 2^(B_i - B_{j+1}) (j < i), 2^(B_NB -
  // B_{j+1}) (j < NB), 2^B_NB
  static constexpr int NVEC = NB + NPAIR + NB + 1;
  static constexpr int kRaw = C * LDF * 4 + 2 * C * LDH * 2;
  static constexpr int kFac = 2 * C * LDF * 4;
  static constexpr int kMain = kRaw > kFac ? kRaw : kFac;
  static constexpr int kBytes = kMain + C * LDH * 2 + C * LDA * 4 +
                                NVEC * D * 4 + (NB + 1) * D * 4 + kP * 4 +
                                D * 4;
  static_assert(C % kSub == 0 && (NB == 2 || NB == 4), "2 or 4 sub-blocks");
  static_assert(kP % D == 0, "whole threads a column");
  static_assert(D % 32 == 0, "head dims of whole warps");
  static_assert(C * D / 4 % kP == 0, "whole factor groups");
};

// Shared memory of a carry CTA (bytes): a ring of NS chunks, each its
// r o 2^cp (C x D), its y and state increments for this CTA's kVB
// columns and its decay; then the state, the mma's B operand.  The
// loads do not depend on the state, so the ring runs NS - 1 chunks
// ahead.
template <int D, int C>
struct CarryLayout {
  static constexpr int VB = kVB;
  static constexpr int NS = 3;
  static constexpr int LDR = D + 4;
  static constexpr int LDV = VB + 4;
  static constexpr int LDS = VB + 8;
  static constexpr int kStage = (C * LDR + C * LDV + D * LDV + D) * 4;
  static constexpr int kBytes = NS * kStage + D * LDS * 4;
  static_assert(VB % 8 == 0 && D % VB == 0 && (VB / 8) * (C / kSub) % 4 == 0,
                "whole consumer tiles");
  static_assert(kQ % (D / 4) == 0 && kQ % (VB / 4) == 0 &&
                    C * D / 4 % kQ == 0 && C * VB / 4 % kQ == 0 &&
                    D * VB % kQ == 0 && D / 4 <= kQ,
                "whole rounds of copies and of state elements");
};

// Level l (8, 4 or 2) of the diagonal sub-block at row ``base``: the
// lower half of each 2l-row group against its upper half, through the
// anchor M = c2 at the upper half's last row, as one m16n8k8 product over
// d whose fragments are built in registers: a-rows tau (the block's 16
// rows; those in an upper half are 0) hold r 2^(cp - M), b-columns n the
// upper-half rows (n / l) 2l + n % l, k 2^(M - c2).  Pairs inside one
// group are kept.
template <int D, int C, int l>
__device__ __forceinline__ void diag_level(const float* c2, const bf16* r_s,
                                           const bf16* k_s, float* A_s,
                                           int base, int lane) {
  constexpr int LDF = D + 4, LDH = D + 8, LDA = C + 4;
  const int g = lane >> 2, tig = lane & 3;
  // rows g and g + 8 lie in lower halves together (or not at all)
  const bool lower = ((g + 8) & (2 * l - 1)) >= l;
  const int ta = base + g, tb = base + g + 8;
  const float* ma = c2 + (base + (g & ~(2 * l - 1)) + l - 1) * LDF;
  const float* mb = c2 + (base + ((g + 8) & ~(2 * l - 1)) + l - 1) * LDF;
  const int sn = base + (g / l) * 2 * l + g % l;
  const float* mn = c2 + (base + (g / l) * 2 * l + l - 1) * LDF;
  float cc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int d = 8 * kk + tig;
    uint32_t af[4] = {0u, 0u, 0u, 0u};
    if (lower) {
      if (l < 8) {
        af[0] = tf32(__bfloat162float(r_s[ta * LDH + d]) *
                     ex2(c2[(ta - 1) * LDF + d] - ma[d]));
        af[2] = tf32(__bfloat162float(r_s[ta * LDH + d + 4]) *
                     ex2(c2[(ta - 1) * LDF + d + 4] - ma[d + 4]));
      }
      af[1] = tf32(__bfloat162float(r_s[tb * LDH + d]) *
                   ex2(c2[(tb - 1) * LDF + d] - mb[d]));
      af[3] = tf32(__bfloat162float(r_s[tb * LDH + d + 4]) *
                   ex2(c2[(tb - 1) * LDF + d + 4] - mb[d + 4]));
    }
    const uint32_t b0 = tf32(__bfloat162float(k_s[sn * LDH + d]) *
                             ex2(mn[d] - c2[sn * LDF + d]));
    const uint32_t b1 = tf32(__bfloat162float(k_s[sn * LDH + d + 4]) *
                             ex2(mn[d + 4] - c2[sn * LDF + d + 4]));
    mma_tf32(cc, af, b0, b1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >> 1), n = 2 * tig + (q & 1);
    const int s = (n / l) * 2 * l + n % l;
    if (row % (2 * l) >= l && row / (2 * l) == s / (2 * l))
      A_s[(base + row) * LDA + base + s] = cc[q];
  }
}

// Level 1 of the diagonal sub-block at row ``base`` (row 2m + 1 against
// 2m: exponent 0, so sum_d r k) and the bonus sum_d r u k on A's
// diagonal, on the CUDA cores: lane = a + 8 dq over the quarter dq of d,
// the quarters summed by shuffles.
template <int D, int C>
__device__ __forceinline__ void diag_pairs(const bf16* r_s, const bf16* k_s,
                                           const float* u_s, float* A_s,
                                           int base, int lane) {
  constexpr int LDH = D + 8, LDA = C + 4;
  const int a = lane & 7, dq = lane >> 3;
  float pr = 0.f, bA = 0.f, bR = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const int d0 = dq * (D / 4) + 4 * j;
    const float4 uu = ld4(u_s + d0);
    float rt[4], ks[4], rA[4], kA[4], rR[4], kR[4];
    ld4_bf16(r_s + (base + 2 * a + 1) * LDH + d0, rt);
    ld4_bf16(k_s + (base + 2 * a) * LDH + d0, ks);
    ld4_bf16(r_s + (base + a) * LDH + d0, rA);
    ld4_bf16(k_s + (base + a) * LDH + d0, kA);
    ld4_bf16(r_s + (base + 8 + a) * LDH + d0, rR);
    ld4_bf16(k_s + (base + 8 + a) * LDH + d0, kR);
    pr += rt[0] * ks[0] + rt[1] * ks[1] + rt[2] * ks[2] + rt[3] * ks[3];
    bA += rA[0] * uu.x * kA[0] + rA[1] * uu.y * kA[1] + rA[2] * uu.z * kA[2] +
          rA[3] * uu.w * kA[3];
    bR += rR[0] * uu.x * kR[0] + rR[1] * uu.y * kR[1] + rR[2] * uu.z * kR[2] +
          rR[3] * uu.w * kR[3];
  }
#pragma unroll
  for (int m = 8; m <= 16; m <<= 1) {
    pr += __shfl_xor_sync(0xffffffffu, pr, m);
    bA += __shfl_xor_sync(0xffffffffu, bA, m);
    bR += __shfl_xor_sync(0xffffffffu, bR, m);
  }
  if (dq == 0) {
    A_s[(base + 2 * a + 1) * LDA + base + 2 * a] = pr;
    A_s[(base + a) * LDA + base + a] = bA;
    A_s[(base + 8 + a) * LDA + base + 8 + a] = bR;
  }
}

// Task ``task`` of the diagonal sub-block ``blk``: 0 level 8, 1 level 2,
// 2 level 4, 3 level 1 and the bonus (two warps a block take 0 + 1 and
// 2 + 3, about equal work).
template <int D, int C>
__device__ __forceinline__ void diag_task(const float* c2, const bf16* r_s,
                                          const bf16* k_s, const float* u_s,
                                          float* A_s, int blk, int task,
                                          int lane) {
  const int base = blk * kSub;
  switch (task) {
    case 0: diag_level<D, C, 8>(c2, r_s, k_s, A_s, base, lane); break;
    case 1: diag_level<D, C, 2>(c2, r_s, k_s, A_s, base, lane); break;
    case 2: diag_level<D, C, 4>(c2, r_s, k_s, A_s, base, lane); break;
    default: diag_pairs<D, C>(r_s, k_s, u_s, A_s, base, lane); break;
  }
}

// A off the diagonal of one chunk on the tensor cores (the consumers'
// first work on it): n8-tile (pair (i, j), half nh) is Qf_i diag(2^(B_i -
// B_{j+1})) Kb_j^T, with gv the scale vectors 2^(B_i - B_{j+1}).  Warp w
// of ``NW`` takes tiles w, w + NW, ..., as independent chains.
template <int D, int C, int NW>
__device__ __forceinline__ void offdiag(const float* Qf, const float* Kb,
                                        const float* gv, float* A_s, int w,
                                        int lane) {
  constexpr int LDF = D + 4, LDA = C + 4;
  constexpr int NPAIR = (C / kSub) * (C / kSub - 1) / 2;
  constexpr int TPW = (2 * NPAIR + NW - 1) / NW;
  const int g = lane >> 2, tig = lane & 3;
  const float* gq[TPW];
  const float* gs[TPW];
  const float* kr[TPW];
  float* ar[TPW];
  bool live[TPW];
  float cc[TPW][4];
#pragma unroll
  for (int x = 0; x < TPW; ++x) {
    const int tile = w + NW * x;
    live[x] = tile < 2 * NPAIR;
    const int pair = live[x] ? tile >> 1 : 0;
    int j = pair, i = 1;
    while (j >= i) {
      j -= i;
      ++i;
    }
    const int nh = tile & 1;
    gq[x] = Qf + (kSub * i + g) * LDF;
    gs[x] = gv + pair * D;
    kr[x] = Kb + (kSub * j + 8 * nh + g) * LDF;
    ar[x] = A_s + (kSub * i + g) * LDA + kSub * j + 8 * nh + 2 * tig;
    cc[x][0] = cc[x][1] = cc[x][2] = cc[x][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int d = 8 * kk + tig;
#pragma unroll
    for (int x = 0; x < TPW; ++x) {
      if (!live[x]) continue;
      const float g0 = gs[x][d], g1 = gs[x][d + 4];
      const uint32_t af[4] = {
          tf32(gq[x][d] * g0), tf32(gq[x][8 * LDF + d] * g0),
          tf32(gq[x][d + 4] * g1), tf32(gq[x][8 * LDF + d + 4] * g1)};
      mma_tf32(cc[x], af, tf32(kr[x][d]), tf32(kr[x][d + 4]));
    }
  }
#pragma unroll
  for (int x = 0; x < TPW; ++x) {
    if (!live[x]) continue;
    ar[x][0] = cc[x][0];
    ar[x][1] = cc[x][1];
    ar[x][8 * LDA] = cc[x][2];
    ar[x][8 * LDA + 1] = cc[x][3];
  }
}

// The intra-chunk grid, one CTA per (slot, head, chunk): the chunk's A
// (diagonal blocks in levels, off-diagonal blocks through the sub-block
// anchors) and factors, then its outputs for the carry grid (see
// chunk_floats).
template <int D, int C>
__global__ void __launch_bounds__(kP)
scan_intra_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* __restrict__ part_out,
                  int Tn, int H, ScanStrides st) {
  using L = IntraLayout<D, C>;
  constexpr int NB = L::NB, NPAIR = L::NPAIR, LDF = L::LDF, LDH = L::LDH,
                LDA = L::LDA;
  extern __shared__ __align__(16) unsigned char smem[];
  float* c2 = reinterpret_cast<float*>(smem);         // logw, then c2
  bf16* r_s = reinterpret_cast<bf16*>(smem + C * LDF * 4);
  bf16* k_s = r_s + C * LDH;
  float* Qf = c2;                                      // over c2
  float* Kb = c2 + C * LDF;                            // over r and k
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kMain);
  float* A_s = reinterpret_cast<float*>(smem + L::kMain + C * LDH * 2);
  float* vec = A_s + C * LDA;
  float* Bl = vec + L::NVEC * D;                       // B_0 .. B_NB
  float* part = Bl + (NB + 1) * D;
  float* u_s = part + kP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * C;

  // the chunk's tiles; rows past T are zero-filled
  {
    const bf16* rb = r + b * st.r_sb + h * st.r_sh;
    const bf16* kb = k + b * st.k_sb + h * st.k_sh;
    const bf16* vb = v + b * st.v_sb + h * st.v_sh;
    const float* wb = logw + b * st.w_sb + h * st.w_sh;
    {
      constexpr int QW = D / 4, RW = kP / QW;
      const int q = tid % QW;
      for (int row = tid / QW; row < C; row += RW) {
        const bool in = t0 + row < Tn;
        const long long t = in ? t0 + row : 0;
        cp_async16(c2 + row * LDF + 4 * q, wb + t * st.w_st + 4 * q, in);
      }
    }
    {
      constexpr int QW = D / 8, RW = kP / QW;
      const int q = tid % QW;
      for (int row = tid / QW; row < C; row += RW) {
        const bool in = t0 + row < Tn;
        const long long t = in ? t0 + row : 0;
        cp_async16(r_s + row * LDH + 8 * q, rb + t * st.r_st + 8 * q, in);
        cp_async16(k_s + row * LDH + 8 * q, kb + t * st.k_st + 8 * q, in);
        cp_async16(v_s + row * LDH + 8 * q, vb + t * st.v_st + 8 * q, in);
      }
    }
    cp_async_commit();
  }
  for (int i = tid; i < D; i += kP) {
    u_s[i] = u[h * D + i];
    Bl[i] = 0.f;
  }
  // the diagonal blocks' upper triangles are 0 (their diagonal is the
  // bonus)
  for (int i = tid; i < NB * kSub * kSub; i += kP) {
    const int blk = i / (kSub * kSub), t = (i / kSub) % kSub, s = i % kSub;
    if (s > t) A_s[(blk * kSub + t) * LDA + blk * kSub + s] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // c2: the chunk's cumulative log decay per column, in log2 units; kP /
  // D threads a column, each over a segment of rows
  {
    constexpr int SEG = C * D / kP;
    const int d = tid % D, seg = tid / D;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < SEG; ++t) sum += c2[(seg * SEG + t) * LDF + d];
    part[tid] = sum;
    __syncthreads();
    float acc = 0.f;
    for (int q = 0; q < seg; ++q) acc += part[q * D + d];
#pragma unroll
    for (int t = 0; t < SEG; ++t) {
      const int row = seg * SEG + t;
      acc += c2[row * LDF + d];
      const float x = acc * kLog2e;
      c2[row * LDF + d] = x;
      if (row % kSub == kSub - 1) Bl[(row / kSub + 1) * D + d] = x;
    }
  }
  __syncthreads();

  // the diagonal blocks, from the raw tiles: four tasks a block, over
  // kPWarps / NB warps
  {
    constexpr int WPB = kPWarps / NB, TPW = 4 / WPB;
#pragma unroll
    for (int x = 0; x < TPW; ++x)
      diag_task<D, C>(c2, r_s, k_s, u_s, A_s, warp / WPB,
                      (warp % WPB) * TPW + x, lane);
  }
  // the factors, into registers while the raw tiles are still read
  constexpr int FG = C * D / 4 / kP;
  float4 qf[FG], kf[FG];
#pragma unroll
  for (int it = 0; it < FG; ++it) {
    const int i = tid + it * kP;
    const int row = i / (D / 4), d0 = 4 * (i % (D / 4));
    const int blk = row / kSub;
    const float4 cw = ld4(c2 + row * LDF + d0);
    const float4 cp = row == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : ld4(c2 + (row - 1) * LDF + d0);
    const float4 bs = ld4(Bl + blk * D + d0);
    const float4 be = ld4(Bl + (blk + 1) * D + d0);
    float rr[4], kk[4];
    ld4_bf16(r_s + row * LDH + d0, rr);
    ld4_bf16(k_s + row * LDH + d0, kk);
    qf[it] = make_float4(rr[0] * ex2(cp.x - bs.x), rr[1] * ex2(cp.y - bs.y),
                         rr[2] * ex2(cp.z - bs.z), rr[3] * ex2(cp.w - bs.w));
    kf[it] = make_float4(kk[0] * ex2(be.x - cw.x), kk[1] * ex2(be.y - cw.y),
                         kk[2] * ex2(be.z - cw.z), kk[3] * ex2(be.w - cw.w));
  }
  // the scale vectors (not overlaid: written now)
  for (int i = tid; i < L::NVEC * D; i += kP) {
    const int which = i / D, d = i % D;
    float x;
    if (which < NB) {
      x = Bl[which * D + d];
    } else if (which < NB + NPAIR) {
      int p = which - NB, ii = 1;
      while (p >= ii) {
        p -= ii;
        ++ii;
      }
      x = Bl[ii * D + d] - Bl[(p + 1) * D + d];
    } else if (which < 2 * NB + NPAIR) {
      const int j = which - NB - NPAIR;
      x = Bl[NB * D + d] - Bl[(j + 1) * D + d];
    } else {
      x = Bl[NB * D + d];
    }
    vec[i] = ex2(x);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < FG; ++it) {
    const int i = tid + it * kP;
    const int row = i / (D / 4), d0 = 4 * (i % (D / 4));
    *reinterpret_cast<float4*>(Qf + row * LDF + d0) = qf[it];
    *reinterpret_cast<float4*>(Kb + row * LDF + d0) = kf[it];
  }
  __syncthreads();
  offdiag<D, C, kPWarps>(Qf, Kb, vec + NB * D, A_s, warp, lane);
  __syncthreads();

  float* out = part_out + (static_cast<long long>(bh) * gridDim.y + c) *
                              chunk_floats<D, C>();
  const float* eB = vec;                               // [NB][D]
  const float* hv = vec + (NB + NPAIR) * D;            // [NB][D]
  // y's chunk-local part A v: warp w takes m-tile w % NB and n-tiles
  // w / NB + x * (kPWarps / NB), independent chains
  {
    constexpr int NTW = (D / 8) * NB / kPWarps;
    const int m = warp % NB, n0 = warp / NB, nstep = kPWarps / NB;
    float yc[NTW][4];
#pragma unroll
    for (int x = 0; x < NTW; ++x) yc[x][0] = yc[x][1] = yc[x][2] = yc[x][3] = 0.f;
    const float* a0 = A_s + (kSub * m + g) * LDA;
    for (int kk = 0; kk < 2 * (m + 1); ++kk) {
      const int sr = 8 * kk + tig;
      const uint32_t af[4] = {tf32(a0[sr]), tf32(a0[8 * LDA + sr]),
                              tf32(a0[sr + 4]), tf32(a0[8 * LDA + sr + 4])};
#pragma unroll
      for (int x = 0; x < NTW; ++x) {
        const int col = 8 * (n0 + x * nstep) + g;
        mma_tf32(yc[x], af, bf16_bits(v_s + sr * LDH + col),
                 bf16_bits(v_s + (sr + 4) * LDH + col));
      }
    }
    const int row = kSub * m + g;
#pragma unroll
    for (int x = 0; x < NTW; ++x) {
      const int e = 8 * (n0 + x * nstep) + 2 * tig;
      *reinterpret_cast<float2*>(out + row * D + e) =
          make_float2(yc[x][0], yc[x][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * D + e) =
          make_float2(yc[x][2], yc[x][3]);
    }
  }
  // the state increment (Kb diag(2^(B_NB - B_{j+1})))^T v, the decayed k
  // split into its TF32 value and the TF32 rounding of the rest: tasks of
  // one m-tile (rows d) by four n-tiles, warp w taking w, w + kPWarps, ..
  {
    constexpr int MD = D / 16, NG = D / 32;
    float* dS = out + 2 * C * D;
    for (int task = warp; task < MD * NG; task += kPWarps) {
      const int d0 = kSub * (task / NG) + g, nb = 4 * (task % NG);
      float acc[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[j][w] = lo[j][w] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C / 8; ++kk) {
        const int sr = 8 * kk + tig;
        const float* hs = hv + (kk / 2) * D;
        const float hl = hs[d0], hh = hs[d0 + 8];
        const float xs[4] = {Kb[sr * LDF + d0] * hl, Kb[sr * LDF + d0 + 8] * hh,
                             Kb[(sr + 4) * LDF + d0] * hl,
                             Kb[(sr + 4) * LDF + d0 + 8] * hh};
        uint32_t hi[4], lw[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float top = tf32_value(xs[w]);
          hi[w] = __float_as_uint(top);
          lw[w] = tf32(xs[w] - top);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * (nb + j) + g;
          const uint32_t b0 = bf16_bits(v_s + sr * LDH + col);
          const uint32_t b1 = bf16_bits(v_s + (sr + 4) * LDH + col);
          mma_tf32(acc[j], hi, b0, b1);
          mma_tf32(lo[j], lw, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * (nb + j) + 2 * tig;
        *reinterpret_cast<float2*>(dS + d0 * D + e) =
            make_float2(acc[j][0] + lo[j][0], acc[j][1] + lo[j][1]);
        *reinterpret_cast<float2*>(dS + (d0 + 8) * D + e) =
            make_float2(acc[j][2] + lo[j][2], acc[j][3] + lo[j][3]);
      }
    }
  }
  // y's carried part's factor Qf diag(2^B_i) = r o 2^cp, and the decay
  {
    float* rd = out + C * D;
#pragma unroll
    for (int it = 0; it < FG; ++it) {
      const int i = tid + it * kP;
      const int row = i / (D / 4), d0 = 4 * (i % (D / 4));
      const float4 q = ld4(Qf + row * LDF + d0);
      const float4 e = ld4(eB + (row / kSub) * D + d0);
      *reinterpret_cast<float4*>(rd + row * D + d0) =
          make_float4(q.x * e.x, q.y * e.y, q.z * e.z, q.w * e.w);
    }
    const float* eC = hv + NB * D;
    for (int i = tid; i < D / 4; i += kP)
      *reinterpret_cast<float4*>(out + 2 * C * D + D * D + 4 * i) =
          ld4(eC + 4 * i);
  }
}

// The carry grid, one CTA per (slot, head, kVB state columns): in chunk
// order, y = y_local + (r o 2^cp) S on the tensor cores, then S <-
// diag(2^c2_C) S + dS in float32, the chunks' pieces arriving through a
// ring of NS cp.async stages.  Writes y (bf16) and the final state.
template <int D, int C>
__global__ void __launch_bounds__(kQ)
scan_carry_kernel(const float* __restrict__ part_in, bf16* __restrict__ y,
                  float* __restrict__ s_out, int Tn, int H, int n_chunks,
                  long long y_sb, long long y_st, long long y_sh) {
  using L = CarryLayout<D, C>;
  constexpr int VB = L::VB, NS = L::NS, LDR = L::LDR, LDV = L::LDV, LDS = L::LDS;
  constexpr int NB = C / kSub, NT = VB / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* S_s = reinterpret_cast<float*>(smem + NS * L::kStage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, e0 = blockIdx.y * VB;
  const int b = bh / H, h = bh - b * H;
  bf16* yb = y + b * y_sb + h * y_sh + e0;
  const float* base = part_in + static_cast<long long>(bh) * n_chunks *
                                    chunk_floats<D, C>();
  auto stage = [&](int i) {
    return reinterpret_cast<float*>(smem + i * L::kStage);
  };
  // each thread's 16-byte pieces: the same (row, column) every chunk, so
  // the offsets are fixed and only the chunk's base moves
  constexpr int QR = D / 4, QV = VB / 4;
  const int rq = tid % QR, rrow = tid / QR;     // rows rrow + j * kQ / QR
  const int vq = tid % QV, vrow = tid / QV;     // rows vrow + j * kQ / QV
  auto load = [&](int c) {
    float* rd = stage(c % NS);
    float* yl = rd + C * LDR;
    float* ds = yl + C * LDV;
    float* ec = ds + D * LDV;
    const float* src = base + c * chunk_floats<D, C>();
#pragma unroll
    for (int j = 0; j < C * QR / kQ; ++j) {
      const int row = rrow + j * (kQ / QR);
      cp_async16(rd + row * LDR + 4 * rq, src + C * D + row * D + 4 * rq,
                 true);
    }
#pragma unroll
    for (int j = 0; j < C * QV / kQ; ++j) {
      const int row = vrow + j * (kQ / QV);
      cp_async16(yl + row * LDV + 4 * vq, src + row * D + e0 + 4 * vq, true);
    }
#pragma unroll
    for (int j = 0; j < D * QV / kQ; ++j) {
      const int row = vrow + j * (kQ / QV);
      cp_async16(ds + row * LDV + 4 * vq,
                 src + 2 * C * D + row * D + e0 + 4 * vq, true);
    }
    if (tid < QR) cp_async16(ec + 4 * tid, src + 2 * C * D + D * D + 4 * tid,
                             true);
  };

  // the state in float32: thread tid owns elements tid + j * kQ (row d =
  // i / VB, column e = i % VB) in registers; S_s is its copy for the mma
  constexpr int SPT = D * VB / kQ;
  float st_reg[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) st_reg[j] = 0.f;
  for (int i = tid; i < D * LDS; i += kQ) S_s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }
  // y: m-tile ym, n-tiles yn0 + x * ynstep
  constexpr int YNW = NT * NB / 4;
  const int ym = warp % NB, yn0 = warp / NB, ynstep = 4 / NB;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    // chunk c + NS - 1 into the stage chunk c - 1 held
    if (c + NS - 1 < n_chunks) load(c + NS - 1);
    cp_async_commit();
    const float* rd = stage(c % NS);
    const float* yl = rd + C * LDR;
    const float* ds = yl + C * LDV;
    const float* ec = ds + D * LDV;
    const int t0 = c * C;
    {
      const int row = kSub * ym + g;
      float yc[YNW][4];
#pragma unroll
      for (int x = 0; x < YNW; ++x) {
        const int e = 8 * (yn0 + x * ynstep) + 2 * tig;
        yc[x][0] = yl[row * LDV + e];
        yc[x][1] = yl[row * LDV + e + 1];
        yc[x][2] = yl[(row + 8) * LDV + e];
        yc[x][3] = yl[(row + 8) * LDV + e + 1];
      }
      const float* a0 = rd + row * LDR;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int d = 8 * kk + tig;
        const uint32_t af[4] = {tf32(a0[d]), tf32(a0[8 * LDR + d]),
                                tf32(a0[d + 4]), tf32(a0[8 * LDR + d + 4])};
#pragma unroll
        for (int x = 0; x < YNW; ++x) {
          const int col = 8 * (yn0 + x * ynstep) + g;
          mma_tf32(yc[x], af, tf32(S_s[d * LDS + col]),
                   tf32(S_s[(d + 4) * LDS + col]));
        }
      }
#pragma unroll
      for (int x = 0; x < YNW; ++x) {
        const int e = 8 * (yn0 + x * ynstep) + 2 * tig;
        if (t0 + row < Tn)
          *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + row) * y_st + e) =
              __floats2bfloat162_rn(yc[x][0], yc[x][1]);
        if (t0 + row + 8 < Tn)
          *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + row + 8) * y_st + e) =
              __floats2bfloat162_rn(yc[x][2], yc[x][3]);
      }
    }
    __syncthreads();
    // S <- diag(2^c2_C) S + dS, in float32
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int i = tid + j * kQ, d = i / VB, e = i % VB;
      st_reg[j] = fmaf(ec[d], st_reg[j], ds[d * LDV + e]);
      S_s[d * LDS + e] = st_reg[j];
    }
  }
  cp_async_wait<0>();
  float* so = s_out + static_cast<long long>(bh) * D * D + e0;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = tid + j * kQ, d = i / VB, e = i % VB;
    so[d * D + e] = st_reg[j];
  }
}

template <typename F>
cudaError_t allow_smem(F kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = e == cudaSuccess;
  return e;
}

// Both grids on ``stream``, chunks of C = chunk_steps<D>() steps;
// ``part`` holds B * H * ceil(T / C) * chunk_floats<D, C>() floats.
template <int D>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, void* y, float* s_out, float* part, int B, int Tn,
           int H, const ScanStrides& st, cudaStream_t stream) {
  constexpr int C = chunk_steps<D>(), VB = kVB;
  constexpr int kIntra = IntraLayout<D, C>::kBytes;
  constexpr int kCarry = CarryLayout<D, C>::kBytes;
  static bool intra_ok = false, carry_ok = false;
  cudaError_t e = allow_smem(scan_intra_kernel<D, C>, kIntra, intra_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(scan_carry_kernel<D, C>, kCarry, carry_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (Tn + C - 1) / C;
  if (n_chunks > 0) {
    scan_intra_kernel<D, C><<<dim3(B * H, n_chunks), kP, kIntra, stream>>>(
        static_cast<const bf16*>(r), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), logw, u, part, Tn, H, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan_carry_kernel<D, C><<<dim3(B * H, D / VB), kQ, kCarry, stream>>>(
      part, static_cast<bf16*>(y), s_out, Tn, H, n_chunks, st.y_sb, st.y_st,
      st.y_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace scan_chunked
}  // namespace repro
