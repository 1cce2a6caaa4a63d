"""W8A8 int8 GEMM: the CUDA kernels' wrapper, its plain version and the
quantizer that feeds it.

``int8_matmul(x, w, sx, sw)`` computes ``(float(x @ w) * sx) * sw`` with
x (M, K) int8, w (K, N) int8, sx (M, 1) and sw (1, N) float32, the
product accumulated exactly in int32.  A CPU tensor goes to
``int8_matmul_plain``; a CUDA tensor launches a hand-written kernel in
``csrc/int8_matmul.cu`` or raises -- there is no fall-back.
``int8_matmul.launches`` counts kernel launches.

A CUDA call takes one of two routes (``plan``, a function of the shape):
``"wgmma"`` where K and N are multiples of 16 (TMA's rule for row
strides; ``csrc/int8_wgmma.cuh``: TMA loads through a ring of
shared-memory stages, w transposed in shared memory, ``wgmma`` s8
products on 128 x 128 tiles), ``"sync"`` for every other
shape (the ``mma.sync`` s8 kernel).  Both compute the same exact int32
sum and the same two float32 multiplies, so both equal the plain version
bit for bit.

Replaces ``src/repro/kernels/int8_matmul/int8_matmul.py:
int8_matmul_kernel`` (wrapper ``ops.py:int8_matmul``, oracle
``ref.py:int8_matmul_ref``).  The reference wrapper pads M, N and K to
its 256 blocks, with scale 1 in the pad; these kernels take any M, N,
K >= 1 and check their own bounds.  They read w in the reference's
row-major (K, N) layout and transpose each tile while staging it, so
callers quantize weights once, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count_launch

# the largest K whose int32 sum cannot overflow: 128 * 128 * K < 2^31
MAX_K = 131_072
# the most row tiles of 128 the sync route's grid takes, and the most
# column tiles of 128 the wgmma route's grid takes
MAX_M = 65_535 * 128
MAX_N_WGMMA = 65_535 * 128
# the device types whose tensors launch a kernel (the tests add "meta" to
# drive the launch path without a card)
LAUNCH_DEVICES = ("cuda",)
# the wgmma route's CTA tile (128 x 128 outputs) and ring (4 stages of
# K 128 bytes; 192 KB of shared memory: one CTA an SM), for the reports
# (``csrc/int8_wgmma.cuh``: kBM, kBN, kStages)
WGMMA_TILE = (128, 128)
WGMMA_STAGES = 4


def plan(m: int, k: int, n: int, out_dtype) -> str:
    """The route of a CUDA call, from the shape alone: ``"wgmma"`` where
    K and N are multiples of 16 (x's and w's rows then start on 16-byte
    boundaries, as TMA requires), else ``"sync"``.  Raises on what
    neither kernel takes."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul: out_dtype {out_dtype}")
    if min(m, n, k) < 1 or k > MAX_K or m > MAX_M:
        raise ValueError(f"int8_matmul: M {m}, N {n}, K {k} outside "
                         f"1 <= K <= {MAX_K}, 1 <= M <= {MAX_M}, N >= 1")
    if k % 16 == 0 and n % 16 == 0 and n <= MAX_N_WGMMA:
        return "wgmma"
    return "sync"


def quantize_int8(x, axis: int = -1):
    """Symmetric per-row/col int8 quantization -> (q, scale_f32).  A copy
    of the reference ``ops.py:quantize_int8``; ``torch.round`` rounds
    half to even, as ``jnp.round`` does, so q and scale agree bit for
    bit."""
    amax = x.float().abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _int_mm_fits(x, w) -> bool:
    """Whether ``torch._int_mm`` takes these shapes on their device: any
    on the CPU; on CUDA M > 16, K and N multiples of 8."""
    if x.device.type != "cuda":
        return True
    m, k = x.shape
    return m > 16 and k % 8 == 0 and w.shape[1] % 8 == 0


def int8_matmul_plain(x, w, sx, sw, out_dtype=torch.bfloat16):
    """The plain version: an exact int32 product, then ``acc * sx * sw``
    in float32 in that order, cast to ``out_dtype``
    (``ref.py:int8_matmul_ref``).  The product is ``torch._int_mm`` where
    its shape rules hold, else (on CUDA, which has no int32 matmul) a
    float64 one: every partial sum is an integer below 2^31, so float64
    holds it exactly."""
    if _int_mm_fits(x, w):
        acc = torch._int_mm(x.contiguous(), w.contiguous())
    else:
        acc = (x.double() @ w.double()).to(torch.int32)
    return ((acc.float() * sx) * sw).to(out_dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int

# the C entry points' argument types: x, w, sx, sw, out, then M, N, K,
# the dtype code, then the stream
ARGTYPES = {
    "int8_matmul_launch": [_P] * 5 + [_I] * 4 + [_P],
    "int8_matmul_wgmma_launch": [_P] * 5 + [_I] * 4 + [_P],
}
ENTRIES = {"sync": "int8_matmul_launch", "wgmma": "int8_matmul_wgmma_launch"}
_D = ctypes.c_double


def _entry(name: str):
    """The C entry point ``name`` with its argument types."""
    fn = getattr(build.library("int8_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES[name]
        fn.restype = _I
    return fn


def wgmma_encode_us(x, w, out, reps: int = 1000) -> float:
    """Host microseconds a wgmma-route call of this shape spends encoding
    its TMA descriptors (the library times ``reps`` encodings)."""
    fn = build.library("int8_matmul").int8_matmul_wgmma_encode_us
    fn.argtypes = [_P] * 3 + [_I] * 5
    fn.restype = _D
    us = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
            w.shape[1], x.shape[1], build.dtype_code(out), reps)
    if us < 0:
        build.check(int(us), "int8_matmul")
    return us


def _aligned(t, n: int):
    """``t`` contiguous with its data on an ``n``-byte boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % n == 0 else t.clone()


def launch(x, w, sx, sw, out_dtype, route: str):
    """One launch of ``route`` on CUDA tensors the wrapper has checked;
    returns the output.  Counts nothing (the wrapper counts).  x is
    aligned to 16 bytes, w to 16 on the wgmma route (TMA) and to 4 on
    the sync route."""
    m, k = x.shape
    n = w.shape[1]
    x, w = _aligned(x, 16), _aligned(w, 16 if route == "wgmma" else 4)
    sx, sw = sx.contiguous(), sw.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _entry(ENTRIES[route])(
        x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), m, n, k, build.dtype_code(out),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "int8_matmul")
    return out


def int8_matmul(x, w, sx, sw, *, out_dtype=torch.bfloat16):
    """x: (M, K) int8; w: (K, N) int8; sx: (M, 1) float32; sw: (1, N)
    float32 -> (M, N) ``out_dtype`` (float32 or bfloat16).  CPU tensors
    take the plain version; CUDA tensors launch the kernel of ``plan``'s
    route (any M, N, K >= 1 up to ``MAX_M`` and ``MAX_K``) or raise."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, sx, sw, out_dtype)
    if x.device.type not in LAUNCH_DEVICES:
        raise ValueError(f"int8_matmul: no path for {x.device}")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 2-D")
    m, k = x.shape
    n = w.shape[1]
    if (w.shape[0] != k or tuple(sx.shape) != (m, 1)
            or tuple(sw.shape) != (1, n)):
        raise ValueError(
            f"int8_matmul: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"sx {tuple(sx.shape)}, sw {tuple(sw.shape)}")
    route = plan(m, k, n, out_dtype)
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul: x and w must be int8, got {x.dtype} "
                        f"and {w.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("int8_matmul: sx and sw must be float32")
    for t in (w, sx, sw):
        if t.device != x.device:
            raise ValueError("int8_matmul: inputs on different devices")
    out = launch(x, w, sx, sw, out_dtype, route)
    count_launch(int8_matmul)
    return out


int8_matmul.launches = 0
