"""AdamW with optional int8-quantized moments (PyTorch port of the
reference ``optim/adamw.py``).

Parameters and moments are dicts of tensors; ``adamw_update`` returns
new ones and leaves its inputs as they are, as the reference's does.
The step is a 0-d int32 tensor, so a step makes no host read.  With
``quant_moments`` m is int8 with a float32 scale per row (last axis)
and v is bfloat16 in sqrt space: linear int8 cannot hold the dynamic
range of g^2, and bf16-sqrt bounds the relative error of the
denominator at every scale.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.param import (tree_leaves, tree_map,
                                      tree_zip_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quant_moments: bool = False


class OptState(NamedTuple):
    step: Any
    m: Any
    v: Any
    m_scale: Any = None     # per-row scales when quant_moments
    v_scale: Any = None


def _q8(x):
    """float32 tensor -> int8 and its per-row (last axis) float32 scale."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q, scale):
    return q.float() * scale


def global_norm(tree):
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's float32 sum of squares: a 0-d float32 tensor."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gnorm, max_norm: float):
    """min(1, max_norm / (norm + 1e-9)): the factor of the global-norm
    clip, a 0-d float32 tensor."""
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``_clip_scale``, norm)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments beside ``params`` (float32 m and v, or int8 m with
    its float32 row scales and bfloat16 sqrt-space v) and step 0."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(dtype, row_scale=False):
        def make(p):
            shape = (p.shape[:-1] + (1,)) if row_scale else p.shape
            return torch.zeros(shape, dtype=dtype, device=p.device)
        return make

    if cfg.quant_moments:
        return OptState(step, tree_map(zeros(torch.int8), params),
                        tree_map(zeros(torch.bfloat16), params),
                        tree_map(zeros(torch.float32, True), params), None)
    return OptState(step, tree_map(zeros(torch.float32), params),
                    tree_map(zeros(torch.float32), params))


def _unzip(tree, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]


def adamw_update(params, grads, state: OptState, lr, cfg: AdamWConfig):
    """One AdamW step: (new params, new OptState, grad norm before
    clipping).  ``lr`` is a float or a 0-d float32 tensor.  The clip of
    ``clip_by_global_norm`` is applied leaf by leaf inside the update
    (the same products), so no clipped copy of the gradients is held."""
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())

    def leaf(p, g, m, v):
        """One leaf's step: (new p, new m, new v).  The reference's
        products in its order, on three buffers of the step's own (the
        clipped float32 gradient, one scratch, then the new moments), so
        that AdamW's memory traffic stays low; m and v are read, never
        written."""
        g = (g * clip.to(g.dtype)).float()
        t = torch.mul(g, 1 - cfg.b1)                     # (1 - b1) g
        m = m * cfg.b1
        m += t
        torch.mul(g, 1 - cfg.b2, out=t).mul_(g)          # (1 - b2) g g
        v = v * cfg.b2
        v += t
        den = torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)
        u = torch.div(m, bc1, out=t).div_(den)           # m^ / (sqrt v^ + eps)
        pf = p.float()
        u.add_(torch.mul(pf, cfg.weight_decay, out=g)).mul_(lr)
        return (pf - u).to(p.dtype), m, v

    if cfg.quant_moments:
        def upd(p, g, mq, ms, vsq):
            newp, m, v = leaf(p, g, _dq8(mq, ms), torch.square(vsq.float()))
            nmq, nms = _q8(m)
            return newp, nmq, nms, torch.sqrt(v).to(torch.bfloat16)

        newp, nm, nms, nv = _unzip(tree_zip_map(
            upd, params, grads, state.m, state.m_scale, state.v), 4)
        return newp, OptState(step, nm, nv, nms, None), gnorm

    newp, nm, nv = _unzip(tree_zip_map(leaf, params, grads, state.m,
                                       state.v), 3)
    return newp, OptState(step, nm, nv), gnorm
