"""RWKV-6 linear scan: the CUDA kernel's wrapper and its plain version.

``linear_scan`` is the model-layout entry point of the RWKV-6
recurrence with data-dependent decay:

  S_t = diag(w_t) S_{t-1} + k_t^T v_t          (w_t = exp(logw_t))
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

A CPU tensor goes to ``linear_scan_plain`` (the copy of the reference's
chunked ``models/rwkv6.py:wkv_chunked``); a CUDA tensor launches the
hand-written kernel in ``csrc/linear_scan.cu`` or raises -- there is no
fall-back.  ``linear_scan.launches`` counts kernel launches.

Replaces ``src/repro/kernels/linear_scan/linear_scan.py:
linear_scan_kernel`` (wrapper ``ops.py:linear_scan``).  The reference
wrapper folds (B, T, H, dh) into (B*H, T, dh) and its kernel needs T to
be a multiple of its chunk; this kernel reads the model layout through
strides and takes any T >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the reference model's chunk (``models/rwkv6.py:CHUNK``)
CHUNK = 256
HEAD_DIMS = (32, 64, 128)


def linear_scan_plain(r, k, v, logw, u, chunk: int = CHUNK, state0=None,
                      return_state: bool = False):
    """Chunked RWKV-6 recurrence, the copy of ``wkv_chunked``.

    r, k, v: (B, S, H, dh); logw: (B, S, H, dh) log decay (<= 0); u:
    (H, dh) bonus; ``state0``: (B, H, dh, dh) float32 or zeros.  Returns
    y (B, S, H, dh) in r's dtype [and the final float32 state].  All
    math is float32, chunk by chunk: the intra-chunk pairwise decay
    exp(clw_t - clw_s), s < t, and the carried state decayed by the
    chunk's product.

    The chunk rule is the reference's, ``min(max(chunk, S // 32), S)``.
    Where the reference asserts ``S % chunk == 0``, the sequence is
    padded to whole chunks with r = k = v = 0 and logw = 0 (w = 1): a
    padded step leaves S as S * 1 + 0, bit for bit, and its rows of y
    are dropped.
    """
    b, s, h, dh = r.shape
    chunk = min(max(chunk, s // 32), s)
    n = -(-s // chunk)
    pad = n * chunk - s
    seqs = [t.float() for t in (r, k, v, logw)]
    if pad:
        seqs = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                for t in seqs]
    rf, kf, vf, lw = (t.reshape(b, n, chunk, h, dh) for t in seqs)
    uf = u.float()
    S = (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    # s < t strict, broadcast over (B, ., ., H, dh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ys = []
    for i in range(n):
        ri, ki, vi, lwi = rf[:, i], kf[:, i], vf[:, i], lw[:, i]
        clw = torch.cumsum(lwi, dim=1)                          # inclusive
        # decay from chunk start to just before t: exp(clw_{t-1})
        clw_prev = clw - lwi
        # inter-chunk: y_cross_t = (r_t * exp(clw_prev_t)) @ S
        y_cross = torch.einsum("bchd,bhde->bche",
                               ri * torch.exp(clw_prev), S)
        # intra-chunk: A[t,s] = sum_d r_t,d k_s,d exp(clw_prev_t - clw_s,d),
        # each exponent <= 0 for s < t
        decay = (clw_prev[:, :, None] - clw[:, None, :]).masked_fill_(
            ~tri[None, :, :, None, None], float("-inf")).exp_()
        att = decay.mul_(ri[:, :, None]).mul_(ki[:, None, :]).sum(-1)
        del decay
        y_intra = torch.einsum("bcsh,bshd->bchd", att, vi)
        # diagonal bonus: u * (r_t . k_t) v_t
        y_diag = (ri * uf * ki).sum(-1, keepdim=True) * vi
        # S' = diag(exp(clw_C)) S + sum_s k_s exp(clw_C - clw_s) v_s
        dec_end = torch.exp(clw[:, -1])                         # (B, H, dh)
        k_dec = ki * torch.exp(clw[:, -1][:, None] - clw)
        S = dec_end[..., None] * S + torch.einsum("bchd,bche->bhde",
                                                  k_dec, vi)
        ys.append(y_cross + y_intra + y_diag)
    y = torch.stack(ys, 1).reshape(b, n * chunk, h, dh)[:, :s].to(r.dtype)
    if return_state:
        return y, S
    return y


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.library("linear_scan")
    fn = lib.linear_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 4 + [_L] * 15 + [_I, _P]
        fn.restype = _I
    return fn


def linear_scan(r, k, v, logw, u):
    """r, k, v: (B, T, H, dh) float32 or bfloat16; logw: (B, T, H, dh)
    float32; u: (H, dh) float32.  Returns (y (B, T, H, dh) in r's dtype,
    final state (B, H, dh, dh) float32) from a zero state.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (dh in {32,
    64, 128}, any T >= 1) or raise."""
    if r.device.type == "cpu":
        return linear_scan_plain(r, k, v, logw, u, return_state=True)
    if r.device.type != "cuda":
        raise ValueError(f"linear_scan: no path for {r.device}")
    b, t, h, dh = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or tuple(u.shape) != (h, dh)):
        raise ValueError(
            f"linear_scan: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, logw {tuple(logw.shape)}, u "
            f"{tuple(u.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"linear_scan: dh {dh} not in {HEAD_DIMS}")
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError("linear_scan: r, k, v dtypes differ")
    for name, x in (("logw", logw), ("u", u)):
        if x.dtype != torch.float32:
            raise TypeError(f"linear_scan: {name} must be float32, got "
                            f"{x.dtype}")
    for x in (k, v, logw, u):
        if x.device != r.device:
            raise ValueError("linear_scan: inputs on different devices")
    r, k, v, logw = (x if x.stride(-1) == 1 else x.contiguous()
                     for x in (r, k, v, logw))
    u = u.contiguous()
    y = torch.empty((b, t, h, dh), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, dh, dh), dtype=torch.float32,
                        device=r.device)
    err = _lib()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h, dh,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3], *y.stride()[:3], build.dtype_code(r),
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "linear_scan")
    linear_scan.launches += 1
    return y, s_out


linear_scan.launches = 0
