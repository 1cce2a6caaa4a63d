// W8A8 int8 GEMM with a fused per-row / per-column dequant epilogue, for
// sm_90a: the mma.sync route, for the shapes off TMA's 16-byte rule (K
// or N not a multiple of 16, e.g. 300 x 500 x 260 or 17 x 500 x 9).
// Every other shape, the tiny keyword spotter's and the LM shapes
// included, takes the wgmma route of int8_wgmma.cuh, whose C entry point
// (int8_matmul_wgmma_launch) this file also exports; ops.py:plan chooses.
//
// Replaces the TPU kernel
//   src/repro/kernels/int8_matmul/int8_matmul.py: int8_matmul_kernel
//   (body _kernel)
// and computes what it computes:
//   out[m][n] = (float(sum_k x[m][k] * w[k][n]) * sx[m]) * sw[n]
// with x (M, K) int8 and w (K, N) int8 both row-major (the reference's
// layout), sx (M, 1) and sw (1, N) float32, the sum in int32 (exact for
// any K <= 131,072, where even 128 * 128 * K stays below 2^31), the two
// multiplies rounded to nearest in that order (__fmul_rn: no contraction
// can change it), and the result stored as float32 or, through
// __float2bfloat16_rn, bfloat16.  Since the integer sum is exact and the
// epilogue's order is fixed, both routes agree with the plain version
// (an exact int32 product, then the same two multiplies) bit for bit.
//
// What bounds it on the H100: bytes where K and N are small (the tiny
// shape's ~4 MB, 1.21 us at 3.35 TB/s), operations where they are large
// (an LM shape's 25.8 GOP, 13.02 us at 1,979 dense int8 TOP/s).  This
// route reaches neither: called through its own entry point at those
// shapes (chip_smoke.py phase 3, kernel-only, NVIDIA H100 80GB HBM3 at
// 700.00 W) it takes 0.0041 ms (tiny) and 0.1145 ms (LM, 8.8x the
// bound), where the wgmma route takes 0.0038 and 0.0330.  The Pallas kernel keeps a 256 x 256 int32 accumulator in VMEM
// across a sequential K grid axis; here each CTA walks K itself:
//   * one CTA of 256 threads (8 warps, 4 x 2) per 128 x 64 output tile;
//     each warp owns a 32 x 32 sub-tile: 2 x 4 tensor-core products
//     mma.sync.m16n8k32.row.col.s32.s8.s8.s32 per 32-deep K step, with
//     its 32 int32 accumulators in registers;
//   * K advances 64 at a time through two shared-memory stages: the next
//     block's global loads are issued into registers before the current
//     block's products, so they are in flight during them;
//   * the layout of w: the B operand of an s8 mma (".col") wants 4
//     consecutive K values of one column packed into one 32-bit word,
//     and row-major (K, N) puts those N bytes apart (ldmatrix.trans only
//     moves 16-bit elements).  Each thread therefore reads a 4 (K) x 4
//     (N) byte block of w as four 32-bit words, transposes it in
//     registers with four byte permutes, and stores it N-major into
//     shared memory, where every fragment is one aligned 32-bit load;
//   * rows of shared memory are 80 bytes (64 + 16), so the eight rows a
//     fragment load touches fall in eight distinct bank groups;
//   * ragged shapes: x is read 16 bytes at a time when K is a multiple of
//     16 and w 4 bytes at a time when N is a multiple of 4; otherwise,
//     and on every tile edge, byte by byte with bounds checks.  Whatever
//     lies past M, N or K is zero-filled, so it adds nothing to the
//     sums, and the epilogue reads sx[m] and sw[n] only for m < M and
//     n < N.

#include <chrono>
#include <cstdint>

#include "common.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int kBM = 128;             // output rows per CTA
constexpr int kBN = 64;              // output columns per CTA
constexpr int kBK = 64;              // K per stage
constexpr int kRow = kBK + 16;       // bytes per shared-memory row
constexpr int kThreads = 256;

struct Stage {
  alignas(16) int8_t a[kBM * kRow];  // x tile, M-major: a[m][k]
  alignas(16) int8_t b[kBN * kRow];  // w tile, N-major: b[n][k]
};

// What one thread carries from global memory into a stage: two 16-byte
// chunks of x and one 4 x 4 block of w (four words, one per K row).
struct Fetch {
  uint4 a[2];
  uint32_t b[4];
};

__device__ __forceinline__ uint32_t pack4(const int8_t* p, bool ok0,
                                          bool ok1, bool ok2, bool ok3) {
  const uint32_t b0 = ok0 ? static_cast<uint8_t>(p[0]) : 0u;
  const uint32_t b1 = ok1 ? static_cast<uint8_t>(p[1]) : 0u;
  const uint32_t b2 = ok2 ? static_cast<uint8_t>(p[2]) : 0u;
  const uint32_t b3 = ok3 ? static_cast<uint8_t>(p[3]) : 0u;
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

__device__ __forceinline__ void fetch(const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ w, int M,
                                      int N, int K, int m0, int n0, int k0,
                                      Fetch& f) {
  const int tid = threadIdx.x;
  // x: 128 rows x 4 chunks of 16 bytes; thread tid takes chunks tid and
  // tid + 256
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int m = m0 + c / 4;
    const int k = k0 + (c % 4) * 16;
    const int8_t* p = x + static_cast<long long>(m) * K + k;
    if ((K % 16) == 0 && m < M && k < K) {
      f.a[i] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kq = k + 4 * q;
        v[q] = m < M ? pack4(p + 4 * q, kq < K, kq + 1 < K, kq + 2 < K,
                             kq + 3 < K)
                     : 0u;
      }
      f.a[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  // w: 16 (K) x 16 (N) blocks of 4 x 4 bytes; neighbouring threads read
  // neighbouring words of one K row
  const int k = k0 + (tid / 16) * 4;
  const int n = n0 + (tid % 16) * 4;
  const bool whole = (N % 4) == 0 && n < N && k + 3 < K;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int8_t* p = w + static_cast<long long>(k + j) * N + n;
    if (whole) {
      f.b[j] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else {
      const bool kin = k + j < K;
      f.b[j] = kin ? pack4(p, n < N, n + 1 < N, n + 2 < N, n + 3 < N) : 0u;
    }
  }
}

__device__ __forceinline__ void store(Stage& s, const Fetch& f) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(&s.a[(c / 4) * kRow + (c % 4) * 16]) = f.a[i];
  }
  // transpose the 4 x 4 byte block: word j of the input holds (k + j,
  // n .. n + 3); word j of the output holds (k .. k + 3, n + j)
  const uint32_t t0 = __byte_perm(f.b[0], f.b[1], 0x5140);
  const uint32_t t1 = __byte_perm(f.b[0], f.b[1], 0x7362);
  const uint32_t t2 = __byte_perm(f.b[2], f.b[3], 0x5140);
  const uint32_t t3 = __byte_perm(f.b[2], f.b[3], 0x7362);
  const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
  const int kk = (tid / 16) * 4;
  const int nn = (tid % 16) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(&s.b[(nn + j) * kRow + kk]) = col[j];
}

__device__ __forceinline__ uint32_t word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename O>
__device__ __forceinline__ void put2(O* out, long long at, int n, int N,
                                     float v0, float v1);

template <>
__device__ __forceinline__ void put2<float>(float* out, long long at, int n,
                                            int N, float v0, float v1) {
  if ((N % 2) == 0 && n + 1 < N) {
    *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
  } else {
    if (n < N) out[at] = v0;
    if (n + 1 < N) out[at + 1] = v1;
  }
}

template <>
__device__ __forceinline__ void put2<__nv_bfloat16>(__nv_bfloat16* out,
                                                    long long at, int n,
                                                    int N, float v0,
                                                    float v1) {
  const __nv_bfloat16 b0 = __float2bfloat16_rn(v0);
  const __nv_bfloat16 b1 = __float2bfloat16_rn(v1);
  if ((N % 2) == 0 && n + 1 < N) {
    __nv_bfloat162 pair;
    pair.x = b0;
    pair.y = b1;
    *reinterpret_cast<__nv_bfloat162*>(out + at) = pair;
  } else {
    if (n < N) out[at] = b0;
    if (n + 1 < N) out[at + 1] = b1;
  }
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ sx,
                   const float* __restrict__ sw, O* __restrict__ out, int M,
                   int N, int K) {
  __shared__ Stage stages[2];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;    // the warp's rows in the tile
  const int wn = (warp % 2) * 32;    // and columns
  const int g = lane / 4;            // mma groupID
  const int t = lane % 4;            // mma threadID_in_group

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int nk = (K + kBK - 1) / kBK;
  Fetch f;
  fetch(x, w, M, N, K, m0, n0, 0, f);
  for (int kt = 0; kt < nk; ++kt) {
    Stage& s = stages[kt & 1];
    store(s, f);
    __syncthreads();
    if (kt + 1 < nk) fetch(x, w, M, N, K, m0, n0, (kt + 1) * kBK, f);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = &s.a[(wm + 16 * i + g) * kRow + ks + 4 * t];
        const int8_t* r1 = r0 + 8 * kRow;
        a[i][0] = word(r0);
        a[i][1] = word(r1);
        a[i][2] = word(r0 + 16);
        a[i][3] = word(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = &s.b[(wn + 8 * j + g) * kRow + ks + 4 * t];
        b[j][0] = word(c0);
        b[j][1] = word(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    // two stages: the next iteration stores into the other one, and the
    // one after waits at that iteration's barrier for every warp to be
    // done with this one
  }

  // epilogue: thread (g, t) holds rows g and g + 8 of each 16-row block,
  // columns 2t and 2t + 1 of each 8-column block
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float sxm = sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n >= N) continue;
        const float sw0 = sw[n];
        const float sw1 = n + 1 < N ? sw[n + 1] : 0.f;
        const float v0 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h]), sxm), sw0);
        const float v1 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sxm), sw1);
        put2<O>(out, static_cast<long long>(m) * N + n, n, N, v0, v1);
      }
    }
  }
}

template <typename O>
int launch(const int8_t* x, const int8_t* w, const float* sx,
           const float* sw, void* out, int M, int N, int K,
           cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<O><<<grid, kThreads, 0, stream>>>(
      x, w, sx, sw, static_cast<O*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) int8, w: (K, N) int8, sx: (M,) float32, sw: (N,) float32,
// out: (M, N) in out_dtype (0 float32, 1 bfloat16); all contiguous, x
// 16-byte and w 4-byte aligned.  M <= 65,535 * 128.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* sx, const void* sw, void* out,
                                  int M, int N, int K, int out_dtype,
                                  void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return repro::kUnsupported;
  if ((M + kBM - 1) / kBM > 65535) return repro::kUnsupported;
  switch (out_dtype) {
    case repro::kFloat32:
      return launch<float>(xp, wp, sxp, swp, out, M, N, K, cs);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(xp, wp, sxp, swp, out, M, N, K, cs);
    default:
      return repro::kUnsupported;
  }
}

// The wgmma route (int8_wgmma.cuh): the same arguments, with K and N
// multiples of 16 and x and w 16-byte aligned.  Returns kUnsupported for
// what the route does not take, kTensorMapFailed if a TMA descriptor
// cannot be encoded.
extern "C" int int8_matmul_wgmma_launch(const void* x, const void* w,
                                        const void* sx, const void* sw,
                                        void* out, int M, int N, int K,
                                        int out_dtype, void* stream) {
  namespace iw = repro::int8_wgmma;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16)
    return repro::kUnsupported;
  if ((N + iw::kBN - 1) / iw::kBN > 65535) return repro::kUnsupported;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return repro::kUnsupported;
  switch (out_dtype) {
    case repro::kFloat32:
      return iw::launch<float>(xp, wp, sxp, swp, out, M, N, K, cs);
    case repro::kBFloat16:
      return iw::launch<__nv_bfloat16>(xp, wp, sxp, swp, out, M, N, K, cs);
    default:
      return repro::kUnsupported;
  }
}

// Host microseconds per call that the wgmma route spends encoding its
// TMA descriptors at this shape and output type (the mean over ``reps``
// encodings into the 16-byte-aligned addresses given; nothing is read
// there).  Negative: the code of the failure.
extern "C" double int8_matmul_wgmma_encode_us(const void* x, const void* w,
                                              void* out, int M, int N, int K,
                                              int out_dtype, int reps) {
  namespace iw = repro::int8_wgmma;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (reps <= 0 || (out_dtype != repro::kFloat32 &&
                    out_dtype != repro::kBFloat16))
    return repro::kUnsupported;
  CUtensorMap tx, tw, to;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int err =
        out_dtype == repro::kFloat32
            ? iw::encode_maps<float>(xp, wp, out, M, N, K, &tx, &tw, &to)
            : iw::encode_maps<__nv_bfloat16>(xp, wp, out, M, N, K, &tx,
                                             &tw, &to);
    if (err) return err;
  }
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}

