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

On a grid (sharded training) ``adamw_update`` takes ``sharding`` =
(grid, the parameters' partition specs): the global norm sums each
leaf's squares over the mesh axes that split it (a replica is counted
once), and ``_q8`` takes the maximum of the whole row, all-reduced over
the axes that split the last dim, as the reference's global math does
(its scales' spec is ``P(*ps[:-1], None)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.param import (tree_leaves, tree_map,
                                      tree_zip_map)
from repro_torch.parallel import collectives as C


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


def _q8(x, row_groups=()):
    """float32 tensor -> int8 and its per-row (last axis) float32 scale;
    the row maximum all-reduced over ``row_groups`` (the groups of the
    mesh axes that split the last dim)."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    for g in row_groups:
        C.all_reduce_max(amax, g)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q, scale):
    return q.float() * scale


def global_norm(tree, sharding=None):
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's float32 sum of squares: a 0-d float32 tensor.  ``sharding``
    (grid, specs): ``tree`` holds this rank's blocks; the squares of the
    leaves split over data, over model and over both are summed over
    those axes (two all-reduces of one 4-vector), replicas once."""
    if sharding is None:
        total = None
        for x in tree_leaves(tree):
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    from repro_torch.parallel.sharding import split_axes
    grid, specs = sharding
    parts = [[] for _ in range(4)]      # by split axes: none, d, m, d+m
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        ax = split_axes(spec)
        parts[("data" in ax) + 2 * ("model" in ax)].append(
            torch.sum(torch.square(x.float())))
    dev = tree_leaves(tree)[0].device
    v = torch.stack([torch.stack(p).sum() if p else
                     torch.zeros((), device=dev) for p in parts])
    mask = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)
    v = v * (1 - mask) + C.all_reduce_sum(v * mask, grid.data_group)
    mask = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    v = v * (1 - mask) + C.all_reduce_sum(v * mask, grid.model_group)
    return torch.sqrt(v.sum())


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


def adamw_update(params, grads, state: OptState, lr, cfg: AdamWConfig,
                 sharding=None):
    """One AdamW step: (new params, new OptState, grad norm before
    clipping).  ``lr`` is a float or a 0-d float32 tensor.  The clip of
    ``clip_by_global_norm`` is applied leaf by leaf inside the update
    (the same products), so no clipped copy of the gradients is held.
    ``sharding`` (grid, specs): every tree holds this rank's blocks."""
    gnorm = global_norm(grads, sharding)
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
        def upd(p, g, mq, ms, vsq, spec=()):
            newp, m, v = leaf(p, g, _dq8(mq, ms), torch.square(vsq.float()))
            groups = ()
            if sharding is not None and spec:
                from repro_torch.parallel.sharding import split_axes
                groups = [sharding[0].group(a)
                          for a in sorted(split_axes(spec[-1:]))]
            nmq, nms = _q8(m, groups)
            return newp, nmq, nms, torch.sqrt(v).to(torch.bfloat16)

        trees = (params, grads, state.m, state.m_scale, state.v)
        if sharding is not None:
            trees += (sharding[1],)
        newp, nm, nms, nv = _unzip(tree_zip_map(upd, *trees), 4)
        return newp, OptState(step, nm, nv, nms, None), gnorm

    newp, nm, nv = _unzip(tree_zip_map(leaf, params, grads, state.m,
                                       state.v), 3)
    return newp, OptState(step, nm, nv), gnorm
