// RWKV-6 linear scan (data-dependent decay), for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/linear_scan/linear_scan.py: linear_scan_kernel
//   (body _kernel)
// and computes what it computes, for each (slot b, head h):
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t          w_t = exp(logw_t)
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// from S_0 = 0, returning every y_t and the final S, a (dh x dh)
// float32 matrix.
//
// Two routes, chosen in Python by ``kernels/linear_scan/ops.py:plan``:
//   * bfloat16 (rwkv6-3b's prefill): the chunked form on the tensor
//     cores, ``scan_chunked.cuh`` (entry ``linear_scan_chunked_launch``);
//   * float32: the CUDA-core loop below (entry ``linear_scan_launch``).
//
// What bounds it on the H100: bytes, in principle.  At the prefill shape
// (B 1, T 1,024, H 48, dh 64, bf16 r/k/v, f32 logw) it reads r, k, v and
// logw once and writes y and S once, ~38.5 MB (~11.5 us at 3.35 TB/s),
// against ~1 GFLOP of state updates.  The float32 loop runs the plain
// recurrence on CUDA cores, so its time is set by the per-step latency
// of one (slot, head) rather than by either bound:
//   * one CTA per (slot, head) walks time in order; thread e owns
//     column e of S, dh float32 values in registers.  Then
//       y_t[e] = sum_d r_d S[d][e] + v_e * sum_d r_d u_d k_d
//       S[d][e] <- w_d S[d][e] + k_d v_e
//     are local to the thread; only r_t, k_t and w_t are shared;
//   * they are staged through shared memory a block of kStageFloats / dh
//     time steps at a time: thread e loads element e of each row
//     (coalesced) into registers, one block ahead, so that the loads are
//     in flight while the block before is computed; staging it, the
//     thread takes exp of the decay and forms r_e u_e k_e, whose row
//     sums (the bonus scalars) are added once per step rather than once
//     per thread;
//   * r, k, v, logw and y are read and written in the model's
//     (B, T, H, dh) layout through strides, and the sequence stops at T:
//     nothing is transposed or padded (the reference wrapper folds to
//     (B*H, T, dh) and needs T to be a multiple of its chunk).
// Its float order differs from the plain version's chunked form.

#include "common.cuh"
#include "scan_chunked.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

// time steps per staged block: 32 / 16 / 8 at dh 32 / 64 / 128, so that
// a thread's share of the next block (4 values a step) fits in registers
// beside its column of S
constexpr int kStageFloats = 1024;

using Strides = repro::ScanStrides;

// Thread e's element of rows [t0, t0 + nt) of r, k, v and logw, into
// registers: the loads of a whole block are issued together and stay in
// flight while the block before it is computed.
template <typename T, int TS>
__device__ __forceinline__ void fetch(const T* rb, const T* kb, const T* vb,
                                      const float* wb, const Strides& st,
                                      int t0, int nt, int e, T (&r)[TS],
                                      T (&k)[TS], T (&v)[TS],
                                      float (&lw)[TS]) {
#pragma unroll
  for (int t = 0; t < TS; ++t) {
    if (t < nt) {
      const long long row = t0 + t;
      r[t] = rb[row * st.r_st + e];
      k[t] = kb[row * st.k_st + e];
      v[t] = vb[row * st.v_st + e];
      lw[t] = wb[row * st.w_st + e];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
linear_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, T* __restrict__ y, float* __restrict__ s_out, int Tn,
                   int H, Strides st) {
  constexpr int TS = kStageFloats / D;
  static_assert(TS <= D, "one bonus row per thread");
  __shared__ __align__(16) float r_s[TS][D];
  __shared__ __align__(16) float k_s[TS][D];
  __shared__ __align__(16) float w_s[TS][D];
  __shared__ float v_s[TS][D];
  __shared__ float p_s[TS][D + 1];   // r_d u_d k_d; +1: rows on distinct banks
  __shared__ float bonus_s[TS];      // sum_d r_d u_d k_d per step

  const int e = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const T* rb = r + b * st.r_sb + h * st.r_sh;
  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const float* wb = logw + b * st.w_sb + h * st.w_sh;
  T* yb = y + b * st.y_sb + h * st.y_sh;
  const float ue = u[h * D + e];     // while staging, thread e is row d = e
  const long long soff = static_cast<long long>(bh) * D * D;

  float S[D];                        // column e of the state
#pragma unroll
  for (int d = 0; d < D; ++d) S[d] = 0.f;

  T rn[TS], kn[TS], vn[TS];
  float wn[TS];
  int nt = min(TS, Tn);
  fetch<T, TS>(rb, kb, vb, wb, st, 0, nt, e, rn, kn, vn, wn);
  for (int t0 = 0; t0 < Tn; t0 += TS) {
    // stage the fetched block: thread e writes element e of each row
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      if (t < nt) {
        const float rv = to_f32(rn[t]);
        const float kv = to_f32(kn[t]);
        r_s[t][e] = rv;
        k_s[t][e] = kv;
        w_s[t][e] = expf(wn[t]);
        v_s[t][e] = to_f32(vn[t]);
        p_s[t][e] = rv * ue * kv;
      }
    }
    __syncthreads();
    if (e < nt) {
      float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        b0 += p_s[e][d];
        b1 += p_s[e][d + 1];
        b2 += p_s[e][d + 2];
        b3 += p_s[e][d + 3];
      }
      bonus_s[e] = (b0 + b1) + (b2 + b3);
    }
    __syncthreads();
    const int n_cur = nt;
    nt = min(TS, Tn - (t0 + TS));
    if (nt > 0) fetch<T, TS>(rb, kb, vb, wb, st, t0 + TS, nt, e, rn, kn, vn, wn);
    for (int t = 0; t < n_cur; ++t) {
      const float ve = v_s[t][e];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[t]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[t]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[t]);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        a0 = fmaf(rr.x, S[4 * q + 0], a0);
        a1 = fmaf(rr.y, S[4 * q + 1], a1);
        a2 = fmaf(rr.z, S[4 * q + 2], a2);
        a3 = fmaf(rr.w, S[4 * q + 3], a3);
        S[4 * q + 0] = fmaf(ww.x, S[4 * q + 0], kk.x * ve);
        S[4 * q + 1] = fmaf(ww.y, S[4 * q + 1], kk.y * ve);
        S[4 * q + 2] = fmaf(ww.z, S[4 * q + 2], kk.z * ve);
        S[4 * q + 3] = fmaf(ww.w, S[4 * q + 3], kk.w * ve);
      }
      const float out = ((a0 + a1) + (a2 + a3)) + bonus_s[t] * ve;
      yb[(t0 + t) * st.y_st + e] = from_f32<T>(out);
    }
    __syncthreads();                 // the next block overwrites the stage
  }
#pragma unroll
  for (int d = 0; d < D; ++d) s_out[soff + d * D + e] = S[d];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, void* y, float* s_out, int B, int Tn, int H,
           const Strides& st, cudaStream_t stream) {
  linear_scan_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, static_cast<T*>(y), s_out, Tn, H,
      st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* r, const void* k, const void* v,
               const float* logw, const float* u, void* y, float* s_out,
               int B, int Tn, int H, const Strides& st, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(r, k, v, logw, u, y, s_out, B, Tn, H, st, stream);
    case 64: return launch<T, 64>(r, k, v, logw, u, y, s_out, B, Tn, H, st, stream);
    case 128: return launch<T, 128>(r, k, v, logw, u, y, s_out, B, Tn, H, st, stream);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// r, k, v, y: (B, T, H, D) float32; logw: (B, T, H, D) float32, all
// with unit stride on D and element strides (batch, time, head) given in
// the order r, k, v, logw, y.  u: (H, D) float32 contiguous.  s_out:
// (B, H, D, D) float32 contiguous, s[d][e].  ``dtype`` must be float32:
// bfloat16 takes linear_scan_chunked_launch.
extern "C" int linear_scan_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* y, void* s_out, int B, int Tn,
    int H, int D, long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long w_sb, long long w_st,
    long long w_sh, long long y_sb, long long y_st, long long y_sh,
    int dtype, void* stream) {
  const Strides st{r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st,
                   v_sh, w_sb, w_st, w_sh, y_sb, y_st, y_sh};
  if (dtype != repro::kFloat32) return repro::kUnsupported;
  if (B <= 0 || H <= 0 || Tn < 0) return 0;
  return dispatch_d<float>(D, r, k, v, static_cast<const float*>(logw),
                           static_cast<const float*>(u), y,
                           static_cast<float*>(s_out), B, Tn, H, st,
                           static_cast<cudaStream_t>(stream));
}

// Steps of the chunked route's chunk at head dim D (0 where no kernel
// is built): the wrapper sizes the scratch by it.
extern "C" int linear_scan_chunked_steps(int D) {
  namespace sc = repro::scan_chunked;
  switch (D) {
    case 32: return sc::chunk_steps<32>();
    case 64: return sc::chunk_steps<64>();
    case 128: return sc::chunk_steps<128>();
    default: return 0;
  }
}

// The chunked route (scan_chunked.cuh): r, k, v, y bfloat16, logw
// float32, in the same layouts; every row start 16-byte aligned.  Chunks
// of C = linear_scan_chunked_steps(D) steps: the intra-chunk grid
// (B * H, chunks), then the carry grid (B * H, D / 32), 32 state columns
// a CTA.  ``scratch``: float32, B * H * chunks * (2 * C * D + D * D + D)
// values, 16-byte aligned.
extern "C" int linear_scan_chunked_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* y, void* s_out, int B, int Tn, int H, int D,
    long long r_sb, long long r_st, long long r_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long w_sb, long long w_st, long long w_sh,
    long long y_sb, long long y_st, long long y_sh, void* scratch,
    void* stream) {
  namespace sc = repro::scan_chunked;
  const repro::ScanStrides st{r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb,
                              v_st, v_sh, w_sb, w_st, w_sh, y_sb, y_st,
                              y_sh};
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* so = static_cast<float*>(s_out);
  float* scr = static_cast<float*>(scratch);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Tn < 0) return 0;
  switch (D) {
    case 32: return sc::launch<32>(r, k, v, lw, uu, y, so, scr, B, Tn, H, st, cs);
    case 64: return sc::launch<64>(r, k, v, lw, uu, y, so, scr, B, Tn, H, st, cs);
    case 128: return sc::launch<128>(r, k, v, lw, uu, y, so, scr, B, Tn, H, st, cs);
    default: return repro::kUnsupported;
  }
}
