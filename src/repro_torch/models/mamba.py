"""Mamba (S6) mixer of the jamba hybrid (PyTorch port of the reference
``models/mamba.py``).

Plain PyTorch: the reference's Mamba is jnp, with no Pallas kernel.
Input-dependent (dt, B, C), diagonal A = -exp(A_log).  ``x_in``, ``z``
and the conv state are in the model dtype; dt, B, C, the discretised
``a_bar`` / ``b_bar`` and the state h are float32, as in the reference.

The prefill recurrence h_t = a_t h_{t-1} + b_t runs in chunks of
``CHUNK`` tokens, the state carried from one chunk to the next; inside a
chunk a Hillis-Steele scan composes the (a, b) pairs in log2(chunk)
elementwise steps (no Python loop over tokens, and no exp of a running
sum, which overflows float32 within a few hundred tokens).  ``a_bar``,
``b_bar`` and h exist one chunk at a time: at d_inner 8,192 one such
tensor is 256 MiB a 512-token chunk.  The reference asserts that S is a
multiple of its chunk; the port takes a ragged last chunk as it is.

``mamba_decode`` writes the slot's new state into the cache in place,
where the reference returns a new state (its jit donates the buffer).
``mamba_block_tp`` is the training mixer split by channels over a
training grid's model group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef

CHUNK = 512


def _dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def mamba_defs(cfg) -> dict:
    mc, d, dt = cfg.mamba, cfg.d_model, cfg.dtype
    d_in = mc.expand * d
    return {
        "in_proj": ParamDef((d, 2 * d_in), ("fsdp", "d_inner"), "normal", dt),
        "conv_w": ParamDef((mc.d_conv, d_in), (None, "d_inner"), "normal", dt,
                           1.0 / math.sqrt(mc.d_conv)),
        "conv_b": ParamDef((d_in,), ("d_inner",), "zeros", dt),
        "x_proj": ParamDef((d_in, _dt_rank(cfg) + 2 * mc.d_state),
                           ("d_inner", None), "normal", dt),
        "dt_proj": ParamDef((_dt_rank(cfg), d_in), (None, "d_inner"),
                            "normal", dt),
        "dt_bias": ParamDef((d_in,), ("d_inner",), "zeros", "float32"),
        "A_log": ParamDef((d_in, mc.d_state), ("d_inner", None), "zeros",
                          "float32"),
        "D": ParamDef((d_in,), ("d_inner",), "ones", "float32"),
        "out_proj": ParamDef((d_in, d), ("d_inner", "fsdp"), "normal", dt,
                             1.0 / math.sqrt(d_in * max(1, 2 * cfg.n_layers))),
    }


def _ssm_chunk(a, b, h=None):
    """Every h_t of one chunk of h_t = a_t h_{t-1} + b_t along axis 1,
    from the carried state ``h`` (B, Din, N), or zeros when ``None``.
    a, b: (B, T, Din, N) float32, overwritten (under autograd, where
    backward needs every step's operands, each step builds new tensors:
    the same values, bit for bit).  Hillis-Steele: after the step of
    distance d, (a_t, b_t) is the composition of the affine maps of
    tokens (t - 2d, t], so after log2(T) steps h_t = a_t h + b_t."""
    t, d = a.shape[1], 1
    taped = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (a, b, h))
    while d < t:
        if taped:
            b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], 1)
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        else:
            b[:, d:] += a[:, d:] * b[:, :-d]
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b if h is None else torch.addcmul(b, a, h[:, None])


def _ssm_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 from a zero state, in chunks of
    ``CHUNK`` (the last one ragged), the state carried across them.
    a, b: (B, S, Din, N) float32 (left as they are).  Returns h for every
    t."""
    hs, h = [], None
    for s0 in range(0, a.shape[1], CHUNK):
        h_c = _ssm_chunk(a[:, s0:s0 + CHUNK].clone(),
                         b[:, s0:s0 + CHUNK].clone(), h)
        hs.append(h_c)
        h = h_c[:, -1]
    return torch.cat(hs, 1)


def _ssm_params(x_in, p, cfg, group=None):
    """dt (B, S, Din), A (Din, N), B and C (B, S, N), float32.
    ``group``: ``x_in`` and ``x_proj``'s rows are one rank's channels
    (``mamba_block_tp``); their partial (dt_low, B, C) is summed over the
    group, and, used whole for the rank's channels, carries back the
    sum of every rank's gradient."""
    mc = cfg.mamba
    proj = x_in @ p["x_proj"]
    if group is not None:
        from repro_torch.parallel.collectives import copy_to, reduce_from
        proj = copy_to(reduce_from(proj, group), group)
    dt_raw, B, C = torch.split(proj, [_dt_rank(cfg), mc.d_state, mc.d_state],
                               dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])
    return dt, A, B.float(), C.float()


def causal_conv(x_in, w, b, state=None):
    """Depthwise causal conv along seq. x_in: (B, S, Din); w: (K, Din).
    ``state`` (B, K-1, Din), the previous K-1 rows (decode), is
    prepended, else zeros; returns (out, the last K-1 rows of the padded
    input: the next call's state)."""
    k = w.shape[0]
    if state is None:
        pad = x_in.new_zeros((x_in.shape[0], k - 1, x_in.shape[2]))
    else:
        pad = state.to(x_in.dtype)
    xp = torch.cat([pad, x_in], dim=1)
    s = x_in.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return out + b, xp[:, -(k - 1):]


def selective_scan(x_in, dt, A, B, C, D):
    """The SSM of a whole prompt from a zero state: y (B, S, Din) float32
    and the final state h (B, Din, N).  ``a_bar``, ``b_bar`` and h are
    built a chunk at a time; y_t = <h_t, C_t> + D x_t."""
    xf = x_in.float()
    ys, h = [], None
    for s0 in range(0, xf.shape[1], CHUNK):
        sl = slice(s0, s0 + CHUNK)
        dt_c = dt[:, sl]
        a = torch.exp(dt_c[..., None] * A)                   # (B,T,Din,N)
        b = (dt_c * xf[:, sl])[..., None] * B[:, sl, None, :]
        h_c = _ssm_chunk(a, b, h)
        ys.append((h_c * C[:, sl, None, :]).sum(-1))
        h = h_c[:, -1]
    return torch.cat(ys, 1) + D * xf, h


def mamba_block(x, p, cfg, return_state: bool = False):
    """Full-sequence Mamba mixer. x: (B, S, d) -> (B, S, d); with
    ``return_state`` also {"h": (B, Din, N) float32, "conv": (B, K-1,
    Din)}, the state after the last token."""
    x_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    x_in, conv_state = causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_in = F.silu(x_in)
    dt, A, B, C = _ssm_params(x_in, p, cfg)
    y, h = selective_scan(x_in, dt, A, B, C, p["D"])
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def mamba_block_tp(x, p, cfg, grid):
    """Training Mamba mixer, channel-parallel over ``d_inner`` on the
    model group of ``grid`` (a ``parallel.grid.Grid``): x (B, S, d)
    replicated over the group -> the output, summed over it.  The rank
    holds channels [r * Din / m, (r + 1) * Din / m) of the conv, the
    scan's parameters, ``x_proj``'s rows and ``out_proj``'s rows.
    ``in_proj`` is the reference's (d, 2 Din) leaf split by columns in
    blocks, so a rank's block holds neither its ``x_in`` nor its ``z``
    channels in general: the leaf is all-gathered over the group (its
    gradient reduce-scattered back) and the rank takes both of its
    column ranges.  The stored block and the checkpoint keep the
    reference's layout."""
    from repro_torch.parallel.collectives import copy_to, gather, reduce_from
    group = grid.model_group
    d_loc = p["conv_w"].shape[1]
    d_in = cfg.mamba.expand * cfg.d_model
    lo = grid.index("model") * d_loc
    w = gather(p["in_proj"], 1, group)
    w = torch.cat([w[:, lo:lo + d_loc], w[:, d_in + lo:d_in + lo + d_loc]], 1)
    x_in, z = (copy_to(x, group) @ w).chunk(2, dim=-1)
    x_in, _ = causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_in = F.silu(x_in)
    dt, A, B, C = _ssm_params(x_in, p, cfg, group)
    y, _ = selective_scan(x_in, dt, A, B, C, p["D"])
    return reduce_from((y.to(x.dtype) * F.silu(z)) @ p["out_proj"], group)


def mamba_decode(x, p, cfg, state):
    """Single-token step. state = {"h": (B, Din, N) float32, "conv": (B,
    K-1, Din)}, both updated in place.  Returns (out (B, 1, d), state)."""
    x_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    x_in, conv_state = causal_conv(x_in, p["conv_w"], p["conv_b"],
                                   state["conv"])
    x_in = F.silu(x_in)
    dt, A, B, C = _ssm_params(x_in, p, cfg)
    xf = x_in[:, 0].float()
    a_bar = torch.exp(dt[:, 0, :, None] * A)                  # (B,Din,N)
    b_bar = (dt[:, 0] * xf)[..., None] * B[:, 0, None, :]
    h = state["h"]
    h.mul_(a_bar).add_(b_bar)
    state["conv"].copy_(conv_state)
    y = (h * C[:, 0, None, :]).sum(-1) + p["D"] * xf
    out = (y[:, None].to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, state


def mamba_state_defs(cfg, batch: int, dtype) -> dict:
    """Shapes and dtypes of one layer's state for ``batch`` rows."""
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return {"h": ((batch, d_in, mc.d_state), torch.float32),
            "conv": ((batch, mc.d_conv - 1, d_in), dtype)}
