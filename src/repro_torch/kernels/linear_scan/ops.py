"""RWKV-6 linear scan: the CUDA kernel's wrapper and its plain version.

``linear_scan`` is the model-layout entry point of the RWKV-6
recurrence with data-dependent decay:

  S_t = diag(w_t) S_{t-1} + k_t^T v_t          (w_t = exp(logw_t))
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

A CPU tensor goes to ``linear_scan_plain`` (the copy of the reference's
chunked ``models/rwkv6.py:wkv_chunked``); a CUDA tensor launches the
hand-written kernel in ``csrc/linear_scan.cu`` or raises -- there is no
fall-back.  ``linear_scan.launches`` counts kernel launches.

A CUDA call takes one of two routes (``plan``): bfloat16 the chunked
form on the tensor cores (``csrc/scan_chunked.cuh``: chunks of 64 steps,
32 at dh 128, in sub-blocks of 16; an intra-chunk grid over every
(slot, head, chunk), then a carry grid over (slot, head, 32 state
columns) that walks the chunks; one launch counted), float32 the
CUDA-core loop.  ``linear_scan_chunked_plain`` is the chunked route's
algorithm at its own layout (anchors, factors, the diagonal blocks in
halves, value split), for the tests.

Replaces ``src/repro/kernels/linear_scan/linear_scan.py:
linear_scan_kernel`` (wrapper ``ops.py:linear_scan``).  The reference
wrapper folds (B, T, H, dh) into (B*H, T, dh) and its kernel needs T to
be a multiple of its chunk; this kernel reads the model layout through
strides and takes any T >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count_launch

# the reference model's chunk (``models/rwkv6.py:CHUNK``)
CHUNK = 256
HEAD_DIMS = (32, 64, 128)
# the chunked route's steps of a sub-block (the tensor-core tile's rows)
SUB = 16
LOG2E = 1.4426950408889634


def plan(dtype, dh: int) -> str:
    """The route of a CUDA call: ``"chunked"`` for bfloat16, ``"loop"``
    for float32.  Raises on what no kernel takes."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"linear_scan: dh {dh} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "loop"
    if dtype != torch.bfloat16:
        raise TypeError(f"linear_scan takes float32 or bfloat16, got "
                        f"{dtype}")
    return "chunked"


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


def linear_scan_chunked_plain(r, k, v, logw, u, chunk: int = 64,
                              sub: int = SUB, value_block=None):
    """The chunked route's algorithm at its own layout, in float32.

    Per chunk of ``chunk`` steps (the sequence zero-padded to whole
    chunks), with c2 the inclusive cumulative sum of logw in log2 units,
    cp its value a step earlier and anchors B_i = c2 at the end of
    sub-block i - 1 (B_0 = 0): the factors Qf = r 2^(cp - B_i) (own
    sub-block's start) and Kb = k 2^(B_{i+1} - c2) (own sub-block's end);
    A's blocks below the diagonal (Qf_i diag(2^(B_i - B_{j+1})) Kb_j^T);
    its diagonal ``sub`` x ``sub`` blocks in halves: at level l = sub /
    2, ..., 2 the lower half of each 2l-row group against its upper half
    through the anchor M = c2 at the upper half's last row, (r 2^(cp -
    M)) (k 2^(M - c2))^T, and at level 1 (row 2m + 1 against 2m, exponent
    0) sum_d r k; the bonus on the diagonal.  Then, ``value_block`` state
    columns at a time (all at once for None), y = (Qf 2^B_i) S + A v and
    S <- diag(2^B_C) S + (Kb 2^(B_C - B_{i+1}))^T v.  Every exponent is
    <= 0.  Returns (y in r's dtype, final state float32)."""
    b, t, h, dh = r.shape
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of sub {sub}")
    vb = dh if value_block is None else value_block
    n = -(-t // chunk)
    pad = n * chunk - t
    nb = chunk // sub
    seqs = [torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
            for x in (r, k, v, logw)]
    # (B, H, n, C, dh)
    rf, kf, vf, lw = (x.reshape(b, n, chunk, h, dh).permute(0, 3, 1, 2, 4)
                      for x in seqs)
    uf = u.float()[None, :, None, :]
    blk = torch.arange(chunk, device=r.device) // sub
    eye = torch.eye(sub, dtype=torch.float32, device=r.device)
    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    y = torch.empty((b, h, n, chunk, dh), dtype=torch.float32,
                    device=r.device)
    for c in range(n):
        rc, kc, vc = rf[:, :, c], kf[:, :, c], vf[:, :, c]
        c2 = torch.cumsum(lw[:, :, c], 2) * LOG2E
        cp = torch.nn.functional.pad(c2, (0, 0, 1, 0))[:, :, :-1]
        anchors = torch.nn.functional.pad(c2[:, :, sub - 1::sub],
                                          (0, 0, 1, 0))   # B_0 .. B_nb
        qf = rc * torch.exp2(cp - anchors[:, :, blk])
        kb = kc * torch.exp2(anchors[:, :, blk + 1] - c2)
        A = torch.zeros((b, h, chunk, chunk), dtype=torch.float32,
                        device=r.device)
        for i in range(nb):
            ri = slice(i * sub, (i + 1) * sub)
            for j in range(i):
                rj = slice(j * sub, (j + 1) * sub)
                g = torch.exp2(anchors[:, :, i] - anchors[:, :, j + 1])
                A[:, :, ri, rj] = (qf[:, :, ri] * g[:, :, None]) @ \
                    kb[:, :, rj].transpose(-1, -2)
            bonus = (rc[:, :, ri] * uf * kc[:, :, ri]).sum(-1)
            A[:, :, ri, ri] = bonus[..., None] * eye
            base, l = i * sub, sub // 2
            while l >= 1:
                for g0 in range(base, base + sub, 2 * l):
                    hi = slice(g0, g0 + l)
                    lo = slice(g0 + l, g0 + 2 * l)
                    m = c2[:, :, g0 + l - 1, None]
                    A[:, :, lo, hi] = (rc[:, :, lo] * torch.exp2(
                        cp[:, :, lo] - m)) @ (kc[:, :, hi] * torch.exp2(
                            m - c2[:, :, hi])).transpose(-1, -2)
                l //= 2
        carried = qf * torch.exp2(anchors[:, :, blk])
        kdec = kb * torch.exp2(anchors[:, :, nb:] - anchors[:, :, blk + 1])
        decay = torch.exp2(anchors[:, :, nb])[..., None]
        for e0 in range(0, dh, vb):
            cols = slice(e0, e0 + vb)
            y[:, :, c, :, cols] = carried @ S[..., cols] + A @ vc[..., cols]
            S[..., cols] = decay * S[..., cols] + \
                kdec.transpose(-1, -2) @ vc[..., cols]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, dh)[:, :t]
    return y.to(r.dtype), S


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


# the C entry points' argument types: a launch takes 7 tensors, B, T, H,
# dh and 15 strides, then dtype (the loop) or the scratch (the chunked
# route), and the stream; ``linear_scan_chunked_steps`` takes dh
ARGTYPES = {
    "linear_scan_launch": [_P] * 7 + [_I] * 4 + [_L] * 15 + [_I, _P],
    "linear_scan_chunked_launch": [_P] * 7 + [_I] * 4 + [_L] * 15
    + [_P, _P],
    "linear_scan_chunked_steps": [_I],
}


def _entry(name: str):
    """The C entry point ``name`` with its argument types."""
    fn = getattr(build.library("linear_scan"), name)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES[name]
        fn.restype = _I
    return fn


def chunk_steps(dh: int) -> int:
    """Steps of the chunked route's chunk at head dim ``dh``, as the
    library is built (64, or 32 at dh 128; 0 where no kernel is)."""
    return _entry("linear_scan_chunked_steps")(dh)


def scratch_floats(b: int, t: int, h: int, dh: int, chunk: int) -> int:
    """float32 values the chunked route's two grids pass through memory:
    per (slot, head, chunk) y's chunk-local part and the carried part's
    factor (chunk x dh each), the state increment (dh x dh) and the decay
    (dh)."""
    return b * h * -(-t // chunk) * (2 * chunk * dh + dh * dh + dh)


def launch(r, k, v, logw, u, route: str):
    """One launch of ``route`` on CUDA tensors the wrapper has checked;
    returns (y, state).  Counts nothing (the wrapper counts).  The
    chunked route's chunk is the library's (``chunk_steps``): it sizes
    the scratch."""
    b, t, h, dh = r.shape
    y = torch.empty((b, t, h, dh), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, dh, dh), dtype=torch.float32,
                        device=r.device)
    args = [r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h, dh,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *logw.stride()[:3], *y.stride()[:3]]
    if route == "chunked":
        # 16-byte cp.async copies of every row
        for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw)):
            per = 16 // x.element_size()
            if x.data_ptr() % 16 or any(st % per for st in x.stride()[:3]):
                raise ValueError(f"linear_scan: {name}'s rows are not "
                                 f"16-byte aligned")
        scratch = torch.empty(scratch_floats(b, t, h, dh, chunk_steps(dh)),
                              dtype=torch.float32, device=r.device)
        args.append(scratch.data_ptr())
        name = "linear_scan_chunked_launch"
    else:
        args.append(build.dtype_code(r))
        name = "linear_scan_launch"
    args.append(torch.cuda.current_stream(r.device).cuda_stream)
    build.check(_entry(name)(*args), "linear_scan")
    return y, s_out


def linear_scan(r, k, v, logw, u):
    """r, k, v: (B, T, H, dh) float32 or bfloat16; logw: (B, T, H, dh)
    float32; u: (H, dh) float32.  Returns (y (B, T, H, dh) in r's dtype,
    final state (B, H, dh, dh) float32) from a zero state.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on ``plan``'s
    route (dh in {32, 64, 128}, any T >= 1) or raise."""
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
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError("linear_scan: r, k, v dtypes differ")
    for name, x in (("logw", logw), ("u", u)):
        if x.dtype != torch.float32:
            raise TypeError(f"linear_scan: {name} must be float32, got "
                            f"{x.dtype}")
    for x in (k, v, logw, u):
        if x.device != r.device:
            raise ValueError("linear_scan: inputs on different devices")
    route = plan(r.dtype, dh)
    r, k, v, logw = (x if x.stride(-1) == 1 else x.contiguous()
                     for x in (r, k, v, logw))
    out = launch(r, k, v, logw, u.contiguous(), route)
    count_launch(linear_scan)
    return out


linear_scan.launches = 0
