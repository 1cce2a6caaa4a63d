"""Tensor-parallel layout of the dense LM (the TP part of the reference
``parallel/sharding.py``), on ``torch.distributed``.

The reference runs the unchanged LM body inside ``shard_map`` on
per-shard weights (Megatron layout: attention heads and FFN width
column/row-split over one mesh axis) and completes every row-parallel
projection with ``tp_psum``.  The port runs one process per shard
instead: each rank keeps its slice of the weights (``shard_params``,
by the logical axis names of the ``ParamDef`` tree), builds the LM from
the per-shard config (``tp_local_config``) and all-reduces each
row-parallel output over the LM's own process group
(``tp_all_reduce``).  The embeddings, norms and LM head stay
replicated, as ``make_tp_rules`` nulls ``vocab``, ``fsdp``, ``batch``
and ``kv_seq``, so every rank argmaxes the full logits and sampling
needs no gather.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# the logical dims ``make_tp_rules`` keeps on the tensor-parallel axis
TP_AXES = ("heads", "kv_heads", "heads_flat", "kv_flat", "d_ff")

_CALLS_LOCK = threading.Lock()


def tp_local_config(cfg, tp: int):
    """The per-shard view of ``cfg`` under ``tp``-way tensor parallelism.

    Attention heads, KV heads and FFN width divide by ``tp``; everything
    a shard computes locally (embeddings, norms, lm head) is unchanged.
    ``d_head`` is pinned explicitly because the derived default
    ``d_model // n_heads`` would change when ``n_heads`` shrinks.
    """
    if tp == 1:
        return cfg
    unsupported = [n for n, v in (("moe", cfg.moe), ("mla", cfg.mla),
                                  ("mamba", cfg.mamba),
                                  ("hybrid", cfg.hybrid),
                                  ("encdec", cfg.encdec))
                   if v is not None]
    if cfg.family != "dense" or unsupported:
        raise ValueError(
            f"tensor-parallel serving supports dense GQA models; "
            f"{cfg.name} is family={cfg.family} ({unsupported})")
    for dim, val in (("n_heads", cfg.n_heads),
                     ("n_kv_heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff)):
        if val % tp != 0:
            raise ValueError(f"{cfg.name}: {dim}={val} not divisible by "
                             f"tp={tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               d_ff=cfg.d_ff // tp, d_head=cfg.head_dim)


def tp_dim(names: Sequence[Optional[str]]) -> Optional[int]:
    """The dimension a parameter with logical ``names`` splits along
    under tensor parallelism: the first named in ``TP_AXES`` (a mesh
    axis may appear only once in a spec, as in the reference's
    ``logical_pspec``), or ``None`` when it is replicated."""
    for i, name in enumerate(names):
        if name in TP_AXES:
            return i
    return None


def shard_params(params, defs, rank: int, tp: int):
    """Rank ``rank``'s weights of ``params`` under ``tp``-way tensor
    parallelism: each leaf whose ``ParamDef`` (the same key in ``defs``)
    names a ``TP_AXES`` dim keeps its ``rank``-th contiguous block along
    it, as an owned copy (the full tensor can be freed); every other
    leaf is the same tensor, replicated."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")

    def walk(p, d, path):
        if isinstance(p, dict):
            if not isinstance(d, dict) or set(p) != set(d):
                raise ValueError(f"params and defs differ at {path!r}")
            return {k: walk(p[k], d[k], f"{path}/{k}") for k in p}
        if tuple(p.shape) != tuple(d.shape):
            raise ValueError(f"{path}: parameter {tuple(p.shape)} != def "
                             f"{tuple(d.shape)}")
        axis = tp_dim(d.names)
        if axis is None or tp == 1:
            return p
        n = p.shape[axis]
        if n % tp:
            raise ValueError(f"{path}: dim {axis} ({d.names[axis]}) of "
                             f"{n} not divisible by tp={tp}")
        step = n // tp
        return p.narrow(axis, rank * step, step).clone()

    return walk(params, defs, "")


def tp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the partial row-parallel output ``x`` over ``group``'s ranks,
    in place (the reference's ``tp_psum``); returns ``x``.
    ``tp_all_reduce.calls`` counts the calls."""
    with _CALLS_LOCK:
        tp_all_reduce.calls += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


tp_all_reduce.calls = 0
