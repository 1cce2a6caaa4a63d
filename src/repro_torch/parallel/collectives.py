"""Collectives with gradients, for sharded training on
``torch.distributed`` (the reference gets these from GSPMD and
``shard_map``: ``psum``, ``all_gather``, ``all_to_all``, ``pmax``).

Each op is one ``torch.autograd.Function`` whose forward and backward
issue at most one collective each over a process group (a data column
or a model row of ``parallel.grid.Grid``).  Every collective runs
whatever the group's size: a group of one rank still calls
``torch.distributed``, so a one-card run issues the same calls as a
wide one.  ``COUNTS`` counts the calls by kind ("all_reduce",
"all_gather", "reduce_scatter", "all_to_all", "all_reduce_max"), where
they are issued, forward or backward, under a lock; ``reset_counts()``
zeroes them.  Serving's tensor parallelism (``LM(tp_group=...)``)
completes its row-parallel outputs with ``all_reduce_sum`` and is
counted in the same place.

The Megatron pair keeps one rule: a tensor replicated over a group
carries, on every rank, the full gradient of its replicated use.

- ``copy_to(x, g)``: identity forward, all-reduce backward (a
  replicated tensor entering a computation each rank does a part of);
- ``reduce_from(x, g)``: all-reduce forward, identity backward (each
  rank's partial sum completed into a replicated tensor);
- ``gather(x, dim, g)``: all-gather forward, reduce-scatter backward (a
  shard of a weight gathered for use on different tokens, FSDP's, or
  the router's over the expert axis);
- ``split(x, dim, g)`` / ``gather_rep(x, dim, g)``: this rank's block of
  a replicated tensor, all-gathered back in backward; and the reverse,
  all-gather forward, this rank's block of the gradient backward (the
  MoE layer's sequence split over the model axis);
- ``all_to_all(x, g)``: blocks of dim 0 exchanged rank to rank,
  forward and backward alike (all_to_all is its own transpose);
- ``all_reduce_max(x, g)``: in place, no gradient.

``torch.distributed.nn.functional`` is not used: its all-reduce
backward all-reduces a gradient that is already replicated, so each
rank's gradient comes out multiplied by the group's size.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

# torch 2.13 renames the tensor forms (the older names warn there)
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "all_reduce_max")
COUNTS = dict.fromkeys(KINDS, 0)
_LOCK = threading.Lock()


def _count(kind: str) -> None:
    with _LOCK:
        COUNTS[kind] += 1


def reset_counts() -> None:
    with _LOCK:
        for k in KINDS:
            COUNTS[k] = 0


def counts() -> dict:
    with _LOCK:
        return dict(COUNTS)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    _count("all_reduce")
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Blocks of every rank along ``dim``, in rank order."""
    _count("all_gather")
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _GATHER(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's block along ``dim``."""
    _count("reduce_scatter")
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _SCATTER(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, dist.get_group_rank(group, dist.get_rank())
                    * step, step).contiguous()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    _count("all_to_all")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_to(x, group):
    """Identity forward; the gradient all-reduced over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The sum over ``group`` forward; the gradient as it is."""
    return _ReduceFrom.apply(x, group)


def gather(x, dim: int, group):
    """All ranks' blocks along ``dim`` forward; the gradient summed over
    ``group`` and cut to this rank's block (reduce-scatter)."""
    return _Gather.apply(x, dim, group)


def split(x, dim: int, group):
    """This rank's block along ``dim`` of a replicated ``x``; the
    gradient's blocks all-gathered back."""
    return _Split.apply(x, dim, group)


def gather_rep(x, dim: int, group):
    """All ranks' blocks along ``dim`` into a replicated tensor; this
    rank's block of the gradient."""
    return _GatherRep.apply(x, dim, group)


def all_to_all(x, group):
    """``x``'s dim-0 block j sent to rank j of ``group``; block j of the
    result came from rank j.  The gradient goes back the same way."""
    return _AllToAll.apply(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group``, in place, no gradient."""
    _count("all_reduce_max")
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


@torch.no_grad()
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, in place, no gradient (serving's
    row-parallel outputs, the reference's ``tp_psum``; metrics, norms)."""
    _count("all_reduce")
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


@torch.no_grad()
def all_gather_nograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All ranks' blocks along ``dim``, no gradient (checkpoints)."""
    return _all_gather(x, dim, group)
