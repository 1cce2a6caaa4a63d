// The tensor-core tile route of attention (bf16, more than 16 query rows
// per KV head): FlashAttention-2's loop on mma.sync for sm_90a, shared
// by flash attention (prefill, whisper's encoder) and by both verify
// kernels (a prefix-cache hit's suffix, T 200 behind 1,024 cached rows).
//
// Query row i of head h sits at position off[b] + i (flash: off = 0;
// verify: off = pos[b], the window start) and attends to keys j < cap of
// KV head h // G, only j <= off[b] + i in the causal form; keys are
// reached through an address map of common.cuh (``Cache``: contiguous
// rows or pages); out = acc / max(l, 1e-30).  What bounds this work on
// the H100 is operations (4 D Sq Skv flop per head against ~4 D (Sq +
// Skv) bytes), so the products run on the bf16 tensor cores:
//   * one CTA of 4 warps per (64 MT-row query tile, batch * head); each
//     warp owns MT m-tiles of 16 query rows (rows mt * 64 + warp * 16 ..
//     + 15 of the tile).  Its Q fragments, its 16 x 64 score tiles and
//     its f32 16 x D output accumulators stay in registers.  Every K/V
//     fragment a warp reads from shared memory feeds its MT m-tiles, so
//     MT = 2 halves the shared-memory traffic per flop; D 64 takes MT 2,
//     D 96 and 128 (a larger accumulator) MT 1;
//   * S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 -> f32, their
//     operands read from shared memory by ldmatrix (.trans for V, whose
//     rows are keys); each 16-wide step issues all its ldmatrix loads
//     before its mma's, so their shared-memory latency overlaps;
//   * K and V arrive in 64-row tiles through a kStages-deep ring of
//     16-byte cp.async.cg copies in dynamic shared memory: tile k + 1
//     and k + 2 are in flight while tile k is multiplied.  Each thread
//     copies one 16-byte chunk of K and of V from each of its rows and
//     looks the row up once (one page-table read per row for pages).
//     Rows are XOR-swizzled in 16-byte chunks (``swz``), so the eight
//     rows one ldmatrix reads sit in eight distinct bank groups;
//   * the online softmax is f32 in registers: a row's max and sum are
//     reduced over the four threads of a quad by two shuffles; exps are
//     exp2 of scores pre-multiplied by scale * log2(e).  P is rounded to
//     bf16 for the P V product (as FlashAttention does), the row sum l
//     is taken from the f32 P;
//   * causal: key tiles past the tile's last live row (off[b] + min(Sq,
//     q0 + rows) - 1) are never loaded, only tiles that cross the shifted
//     diagonal are masked, and the q-tiles launch in reverse order so the
//     longest rows start first;
//   * ragged edges: query rows past Sq are zero-filled and never stored;
//     key rows past the last one any row sees (cap, or the causal k_end)
//     are zero-filled by cp.async's src-size operand, never read, and
//     score -inf, so whisper's 1,500 keys need no padding and no page
//     past a verify window is touched;
//   * q and o are read and written through their (B, S, heads, D)
//     strides; the wrappers check that every row start is 16-byte
//     aligned.
// Key 0 is visible to every row and sits in the first tile, so each
// row's running max is finite from the first tile on.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace mma_tile {
// Internal linkage: each library that includes this header (flash's and
// both verify kernels') gets its own kernel and its own ``configured``
// flag in ``launch``.  With vague linkage the flag would be one symbol
// for the whole process, and a library whose kernel never had its
// shared-memory attribute set would find it already "configured".
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;             // key rows per K/V tile
constexpr int kWarps = 4;           // 16 MT query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;          // depth of the K/V ring

// m-tiles of 16 rows per warp, and query rows per CTA, at head dim D
template <int D>
__host__ __device__ constexpr int m_tiles() {
  return D == 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int block_q() {
  return 16 * kWarps * m_tiles<D>();
}

// dynamic shared memory of one CTA: the Q tile and kStages K and V tiles
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (block_q<D>() + 2 * kStages * kBK) * D *
         static_cast<int>(sizeof(bf16));
}

// element offset of (row, 16-byte chunk) in a swizzled tile of D
// columns; every chunk stays inside its row.  With 8 or 16 chunks a row
// the swizzle is chunk ^ (row & 7).  With 12 (D 96) a row starts 4 bank
// groups (of 8) past the previous one: chunks 0-7 take chunk ^ (row & 7)
// (16-byte unit row * 12 + that lands in group chunk ^ r ^ 4 (r & 1), r =
// row & 7: distinct over 8 rows), chunks 8-11 stay in 8-11 as 8 + ((chunk
// - 8) ^ ((row >> 1) & 3)) (group 4 (r & 1) + that: distinct too).  So the
// eight rows of one ldmatrix (8 consecutive rows from a multiple of 8, one
// logical chunk) hit eight distinct bank groups at every D.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (D / 8 % 8 == 0) {
    return row * D + ((chunk ^ (row & 7)) << 3);
  } else {
    static_assert(D / 8 == 12, "8, 12 or 16 chunks a row");
    const int c = chunk < 8 ? chunk ^ (row & 7)
                            : 8 + ((chunk - 8) ^ ((row >> 1) & 3));
    return row * D + (c << 3);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16 pair, ``lo`` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows r0 .. r0 + ROWS - 1 of a (rows, D) matrix with row stride ``ss``
// into a swizzled tile; rows at or past ``n_rows`` are zero-filled (the
// Q tile).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g,
                                          long long ss, int r0, int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n_rows;
    cp_async16(tile + swz<D>(r, c), g + (in ? r0 + r : 0) * ss + c * 8, in);
  }
}

// Key rows r0 .. r0 + kBK - 1 of one (slot, KV head) through its address
// map into swizzled K and V tiles; rows at or past ``n_rows`` are
// zero-filled.  Round ``it`` of thread t copies chunk i % (D / 8) of row
// i / (D / 8), i = t + kThreads * it, K's and V's: one ``at`` lookup per
// row it touches (at D 64 and 128 a thread keeps its chunk and steps
// whole rows; at D 96 both move).
template <int D, typename Map>
__device__ __forceinline__ void load_kv_tile(bf16* kt, bf16* vt,
                                             const Map& rows, int r0,
                                             int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(kBK * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n_rows;
    const bf16 *kp, *vp;
    rows.at(in ? r0 + r : 0, kp, vp);
    cp_async16(kt + swz<D>(r, c), kp + c * 8, in);
    cp_async16(vt + swz<D>(r, c), vp + c * 8, in);
  }
}

template <int D, typename Cache>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const bf16* __restrict__ q, Cache kv,
                 const int* __restrict__ off, bf16* __restrict__ o, int Sq,
                 int cap, int H, int G, long long q_sb, long long q_ss,
                 long long q_sh, long long o_sb, long long o_ss,
                 long long o_sh, float scale_log2, bool causal) {
  constexpr int MT = m_tiles<D>();
  constexpr int kBQ = block_q<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * D;                       // kStages K tiles
  bf16* vs = ks + kStages * kBK * D;             // kStages V tiles

  // causal: the last q-tile (the longest rows) is launched first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / G;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const auto rows = kv.slot(b, kvh);
  const int pos0 = off ? off[b] : 0;             // row i sits at pos0 + i
  // causal: the tile's last live row sits at pos0 + min(Sq, q0 + kBQ) -
  // 1; no key past it counts
  const int k_end = causal ? min(cap, pos0 + min(Sq, q0 + kBQ)) : cap;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;                      // row in an 8-row group
  const int tq = lane & 3;                       // thread in its quad
  // m-tile mt's first row in the CTA's tile; this thread's rows in it
  // are that + gq (element e < 2) and + gq + 8 (e >= 2)
  int mrow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mrow[mt] = mt * 64 + warp * 16;

  // Q and the first kStages - 1 K/V tiles; Q rides in the first group
  load_tile<D, kBQ>(qs, qb, q_ss, q0, Sq);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_kv_tile<D>(ks + s * kBK * D, vs + s * kBK * D, rows, s * kBK,
                      k_end);
    cp_async_commit();
  }

  uint32_t qf[MT][D / 16][4];
  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];          // running max (raw score), part of l
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();                // tile kt has landed
    __syncthreads();                             // ... for every thread,
    {                                            // and tile kt - 1 is done
      const int nt = kt + kStages - 1;
      if (nt < n_tiles) {
        const int st = nt % kStages;
        load_kv_tile<D>(ks + st * kBK * D, vs + st * kBK * D, rows,
                        nt * kBK, k_end);
      }
      cp_async_commit();
    }
    if (kt == 0) {
      // A fragments of each m-tile's 16 rows: matrices (rows 0-7, cols
      // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of each 16-col step
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[mt][kk], qs + swz<D>(mrow[mt] + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          kk * 2 + (lane >> 4)));
    }
    const bf16* kst = ks + (kt % kStages) * kBK * D;
    const bf16* vst = vs + (kt % kStages) * kBK * D;

    // S = Q K^T: 8 column tiles of 8 keys.  One ldmatrix.x4 gives the B
    // fragments of two of them: (keys 0-7, d 0-7), (0-7, 8-15), (8-15,
    // 0-7), (8-15, 8-15) of a 16-key x 16-d block; every m-tile uses them
    float s[MT][kBK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[kBK / 16][4];                   // the step's fragments,
#pragma unroll                                   // all in flight first
      for (int np = 0; np < kBK / 16; ++np)
        ldsm_x4(r[np], kst + swz<D>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                    kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], r[np][0], r[np][1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], r[np][2], r[np][3]);
        }
      }
    }

    const int k0 = kt * kBK;
    uint32_t pf[MT][kBK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // this thread's two rows' positions
      const int row0 = pos0 + q0 + mrow[mt] + gq, row1 = row0 + 8;
      // mask: keys past cap, and in the causal form keys past the row;
      // only a tile that reaches past cap or past the m-tile's first row
      if (k0 + kBK > cap ||
          (causal && k0 + kBK - 1 > pos0 + q0 + mrow[mt])) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + tq * 2 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (key >= cap || (causal && key > row))
              s[mt][j][e] = -INFINITY;
          }
      }

      // online softmax over the tile: element e of s[mt][j] is row e < 2
      // ? row0 : row1, key j * 8 + tq * 2 + (e & 1)
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
      const float alpha0 = exp2f(m[mt][0] * scale_log2 - ms0);
      const float alpha1 = exp2f(m[mt][1] * scale_log2 - ms1);
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      // P as A fragments of the P V product: keys 16 i .. 16 i + 15 are
      // column tiles 2 i (a0, a1) and 2 i + 1 (a2, a3)
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p0 = exp2f(s[mt][j][0] * scale_log2 - ms0);
        const float p1 = exp2f(s[mt][j][1] * scale_log2 - ms0);
        const float p2 = exp2f(s[mt][j][2] * scale_log2 - ms1);
        const float p3 = exp2f(s[mt][j][3] * scale_log2 - ms1);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        pf[mt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[mt][0] = l[mt][0] * alpha0 + ls0;
      l[mt][1] = l[mt][1] * alpha1 + ls1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[mt][n][0] *= alpha0;
        acc[mt][n][1] *= alpha0;
        acc[mt][n][2] *= alpha1;
        acc[mt][n][3] *= alpha1;
      }
    }

    // O += P V: V's rows are keys, so ldmatrix.trans; one x4 gives the B
    // fragments of two 8-column d tiles: (keys 0-7, d 0-7), (8-15, 0-7),
    // (0-7, 8-15), (8-15, 8-15) of a 16-key x 16-d block
#pragma unroll
    for (int i = 0; i < kBK / 16; ++i) {
      uint32_t r[D / 16][4];                     // the step's fragments,
#pragma unroll                                   // all in flight first
      for (int np = 0; np < D / 16; ++np)
        ldsm_x4_trans(r[np], vst + swz<D>(i * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          np * 2 + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], pf[mt][i], r[np][0], r[np][1]);
          mma_bf16(acc[mt][2 * np + 1], pf[mt][i], r[np][2], r[np][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // l over the quad, then each m-tile's two rows as bf16 pairs
  bf16* ob = o + b * o_sb + h * o_sh + tq * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lt = l[mt][half];
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, w);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int row = q0 + mrow[mt] + gq + half * 8;
      if (row < Sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(ob + row * o_ss + n * 8) =
              pack_bf16(acc[mt][n][2 * half] * inv,
                        acc[mt][n][2 * half + 1] * inv);
      }
    }
  }
}

// q, o: (B, Sq, H, D) with element strides qs, os (batch, seq, head);
// keys through ``kv`` up to ``cap``; off: (B,) int32 position of each
// slot's query row 0, or null for 0.
template <int D, typename Cache>
int launch(const bf16* q, const Cache& kv, const int* off, bf16* o, int B,
           int Sq, int cap, int H, int G, const long long* qs,
           const long long* os, float scale_log2, bool causal,
           cudaStream_t stream) {
  static bool configured = false;  // once per library and instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D, Cache>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + block_q<D>() - 1) / block_q<D>(), B * H);
  flash_mma_kernel<D, Cache><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      q, kv, off, o, Sq, cap, H, G, qs[0], qs[1], qs[2], os[0], os[1],
      os[2], scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mma_tile
}  // namespace repro
