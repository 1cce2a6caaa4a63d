"""RWKV-6 "Finch" block (PyTorch port of the reference ``models/rwkv6.py``):
attention-free time-mix with data-dependent decay [arXiv:2404.05892],
plus the squared-ReLU channel-mix.

The same parameter tree and math as the reference, as functions on
tensors.  Heads are padded from 40 to 48 (a multiple of 16), as in the
reference; the 8 padding heads carry random weights and do real work.
The reference's ``shard`` calls are dropped: sharded training runs
``time_mix_tp`` (by heads) and ``channel_mix_tp`` (by ``d_ff``) on a
training grid's model group instead.

The sequence recurrence of prefill is ``linear_scan``: on CUDA with
``kernels`` the hand-written kernel, otherwise the plain chunked form
(``wkv_chunked``, the reference's algorithm and chunk).  Decode runs the
one-token recurrence and updates the state in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import (CHUNK, linear_scan,
                                                 linear_scan_plain)
from repro_torch.models.param import ParamDef

LORA = 64

# the counterpart of the reference's ``wkv_chunked``
wkv_chunked = linear_scan_plain


def padded_heads(cfg) -> int:
    return -(-cfg.n_heads // 16) * 16


def rwkv_time_defs(cfg) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    hp = padded_heads(cfg)
    dh = cfg.head_dim
    dp = hp * dh
    return {
        "mix_r": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "mix_k": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "mix_v": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "mix_w": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "mix_g": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "w_r": ParamDef((d, dp), ("fsdp", "rwkv_heads"), "normal", dt),
        "w_k": ParamDef((d, dp), ("fsdp", "rwkv_heads"), "normal", dt),
        "w_v": ParamDef((d, dp), ("fsdp", "rwkv_heads"), "normal", dt),
        "w_g": ParamDef((d, dp), ("fsdp", "rwkv_heads"), "normal", dt),
        "w_o": ParamDef((dp, d), ("rwkv_heads", "fsdp"), "normal", dt,
                        1.0 / math.sqrt(dp * max(1, 2 * cfg.n_layers))),
        # data-dependent decay: w_t = exp(-exp(w0 + lora(x)))
        "decay_w0": ParamDef((dp,), ("rwkv_heads",), "small", "float32", 0.3),
        "decay_a": ParamDef((d, LORA), ("fsdp", None), "normal", dt),
        "decay_b": ParamDef((LORA, dp), (None, "rwkv_heads"), "small", dt),
        "bonus_u": ParamDef((dp,), ("rwkv_heads",), "small", "float32", 0.3),
        "ln_out": ParamDef((dp,), ("rwkv_heads",), "ones", dt),
    }


def rwkv_channel_defs(cfg) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "mix_k": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "mix_r": ParamDef((d,), ("embed",), "small", dt, 0.5),
        "w_k": ParamDef((d, f), ("fsdp", "d_ff"), "normal", dt),
        "w_v": ParamDef((f, d), ("d_ff", "fsdp"), "normal", dt,
                        1.0 / math.sqrt(f * max(1, 2 * cfg.n_layers))),
        "w_r": ParamDef((d, d), ("fsdp", "embed"), "normal", dt),
    }


def _token_shift(x, last=None):
    """x_{t-1} stream; ``last`` (B, 1, d) carries state at decode."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return last


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _group_norm(x, w, n_heads, eps=1e-5):
    """Per-head normalisation with float32 statistics, cast back to
    x's dtype."""
    b, s, _ = x.shape
    xh = x.reshape(b, s, n_heads, -1).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, -1) * w).to(x.dtype)


def _local_heads(p, cfg) -> int:
    """The (padded) heads of the time-mix weights ``p``: every padded
    head, or one device's share of them under a sharding table
    (``parallel.sharding.local_shape``)."""
    return p["w_r"].shape[1] // cfg.head_dim


def _time_mix_io(x, p, cfg, x_prev):
    hp = _local_heads(p, cfg)
    dh = cfg.head_dim
    b, s, _ = x.shape
    xs = _token_shift(x, x_prev)
    r = _mix(x, xs, p["mix_r"]) @ p["w_r"]
    k = _mix(x, xs, p["mix_k"]) @ p["w_k"]
    v = _mix(x, xs, p["mix_v"]) @ p["w_v"]
    g = _mix(x, xs, p["mix_g"]) @ p["w_g"]
    xw = _mix(x, xs, p["mix_w"])
    dd = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]          # data-dep decay
    logw = -torch.exp(p["decay_w0"] + dd.float())              # <= 0
    shp = (b, s, hp, dh)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), g,
            logw.reshape(shp))


def time_mix(x, p, cfg, *, kernels: bool = True):
    """RWKV-6 time-mix over a full sequence from a zero state.  x: (B, S,
    d).  Returns (out (B, S, d), final state (B, H, dh, dh) float32)."""
    hp = _local_heads(p, cfg)
    b, s, _ = x.shape
    r, k, v, g, logw = _time_mix_io(x, p, cfg, None)
    u = p["bonus_u"].reshape(hp, cfg.head_dim)
    if kernels:
        y, S = linear_scan(r, k, v, logw, u)
    else:
        y, S = linear_scan_plain(r, k, v, logw, u, chunk=CHUNK,
                                 return_state=True)
    y = _group_norm(y.reshape(b, s, -1), p["ln_out"], hp)
    return (y * F.silu(g)) @ p["w_o"], S


def time_mix_decode(x, p, cfg, state):
    """One token.  state = {"S": (B, H, dh, dh) float32, "x_prev": (B, 1,
    d)}; ``state["S"]`` is updated in place (the reference returns a new
    one).  Returns (out (B, 1, d), {"S": S, "x_prev": x})."""
    hp = _local_heads(p, cfg)
    dh = cfg.head_dim
    b = x.shape[0]
    r, k, v, g, logw = _time_mix_io(x, p, cfg, state["x_prev"])
    u = p["bonus_u"].reshape(hp, dh)
    rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))
    lw = logw[:, 0]
    S = state["S"]
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    y = torch.einsum("bhd,bhde->bhe", rf, S + u[None, :, :, None] * kv)
    S.mul_(torch.exp(lw)[..., None]).add_(kv)
    y = y.to(x.dtype)               # keep the residual stream in bf16
    y = _group_norm(y.reshape(b, 1, -1), p["ln_out"], hp)
    y = (y * F.silu(g)) @ p["w_o"]
    return y, {"S": S, "x_prev": x}


def channel_mix(x, p, x_prev=None):
    xs = _token_shift(x, x_prev)
    k = _mix(x, xs, p["mix_k"]) @ p["w_k"]
    kv = torch.square(torch.relu(k)) @ p["w_v"]
    r = torch.sigmoid(_mix(x, xs, p["mix_r"]) @ p["w_r"])
    return r * kv


# the time-mix leaves every rank uses whole for its own heads
_TIME_SHARED = ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "decay_a")


def time_mix_tp(x, p, cfg, grid):
    """Training time-mix on this rank's (padded) heads over the model
    group of ``grid``: ``w_r``/``w_k``/``w_v``/``w_g`` split by columns,
    ``decay_b``, ``decay_w0``, ``bonus_u`` and the group norm by heads,
    ``w_o`` by rows.  x (B, S, d) and the leaves every rank uses whole
    (the five mixes and ``decay_a``) enter through ``copy_to``; the
    output is summed over the group.  Padded heads compute like real
    ones, as in the reference: a rank may hold padding only."""
    from repro_torch.parallel.collectives import copy_to, reduce_from
    group = grid.model_group
    p = {k: copy_to(v, group) if k in _TIME_SHARED else v
         for k, v in p.items()}
    o, _ = time_mix(copy_to(x, group), p, cfg, kernels=False)
    return reduce_from(o, group)


def channel_mix_tp(x, p, group):
    """Training channel-mix with ``w_k`` split by columns and ``w_v`` by
    rows (``d_ff``) over ``group``: only that branch is split, so its
    mixed input enters through ``copy_to`` and its output is summed;
    the receptance ``r`` is computed whole on every rank."""
    from repro_torch.parallel.collectives import copy_to, reduce_from
    xs = _token_shift(x)
    k = copy_to(_mix(x, xs, p["mix_k"]), group) @ p["w_k"]
    kv = reduce_from(torch.square(torch.relu(k)) @ p["w_v"], group)
    r = torch.sigmoid(_mix(x, xs, p["mix_r"]) @ p["w_r"])
    return r * kv


def rwkv_state_defs(cfg, batch: int, dtype) -> dict:
    """Shapes and dtypes of one layer's recurrent state for ``batch``
    rows: the (H, dh, dh) float32 matrix and the two token-shift rows."""
    hp = padded_heads(cfg)
    dh = cfg.head_dim
    return {"S": ((batch, hp, dh, dh), torch.float32),
            "x_prev_t": ((batch, 1, cfg.d_model), dtype),
            "x_prev_c": ((batch, 1, cfg.d_model), dtype)}
