"""Tensor-parallel continuous batching: the engine sharded over ranks
(PyTorch port of the reference ``serving/sharded.py``).

The reference wraps the slot engine's jitted bodies in ``shard_map``
over a 1-D mesh.  The port runs one process per shard
(``repro_torch.parallel.run_tp``) and each rank holds a
``ShardedContinuousBatchingEngine``:

- its weights are its slice of the Megatron layout
  (``parallel.shard_params``: heads and FFN width column/row-split,
  embeddings and LM head replicated), and its model is the same ``LM``
  built from the per-shard config (``parallel.tp_local_config``) with
  the group, so each row-parallel projection ends in an all-reduce;
- its KV cache or page pool holds only its KV heads, so the decode and
  verify kernels simply see ``kvh / tp`` heads; the per-slot
  positions, tokens, budgets, page tables and page pool are replicated
  host decisions;
- the speculative draft is built without a group and runs replicated.

Every rank must make the same host decisions, or the ranks diverge and
deadlock in a collective.  Admission, scheduler order, park/resume and
chunk ends read the serve's clock, so ``serve`` reads rank 0's clock
and broadcasts each reading; everything else follows from the requests
(rank 0's, broadcast at the start of each serve) and the device
results, which are identical on every rank after the all-reduces.

Rank 0 drives: its ``serve`` sends the request list to the other ranks.
They either call ``serve`` too (SPMD), or sit in ``follow()``, which
serves each list rank 0 sends until rank 0 calls ``close()``; that is
how a ``ShardedSUT`` on rank 0 runs under ``PowerRun``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import shard_params, tp_local_config
from repro_torch.serving.engine import ContinuousBatchingEngine, Request


def replicate_kv_heads(model, params, tp: int):
    """GQA with fewer KV heads than shards: duplicate each KV head
    ``tp / n_kv_heads`` times so every shard owns exactly one copy.

    Repeating KV heads (and regrouping queries accordingly) computes
    the same attention -- each query head still sees its original K/V
    rows -- at the cost of the duplicated cache rows.  Returns the
    equivalent ``(model, params)`` with ``n_kv_heads == tp``; the
    params share every leaf but ``wk``/``wv``/``bk``/``bv``.
    """
    cfg = model.cfg
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    if tp % kvh != 0:
        raise ValueError(f"{cfg.name}: n_kv_heads={kvh} neither divides "
                         f"nor is divided by tp={tp}")
    r = tp // kvh

    def expand(w):
        """Repeat the per-KV-head blocks of a trailing (kvh*dh) dim."""
        lead = w.shape[:-1]
        w = w.reshape(lead + (kvh, dh))
        return w.repeat_interleave(r, dim=-2).reshape(lead + (kvh * r * dh,))

    blocks = dict(params["blocks"])
    attn = dict(blocks["attn"])
    for name in ("wk", "wv", "bk", "bv"):
        if name in attn:
            attn[name] = expand(attn[name])
    blocks["attn"] = attn
    params = dict(params, blocks=blocks)
    cfg2 = dataclasses.replace(cfg, n_kv_heads=tp, d_head=dh)
    return type(model)(cfg2, model.device, kernels=model.kernels), params


def _no_sleep(dt: float) -> None:
    """A follower's sleep: its next clock read waits in the broadcast
    until rank 0 has slept."""


class ShardedContinuousBatchingEngine(ContinuousBatchingEngine):
    """``ContinuousBatchingEngine`` partitioned ``tp`` ways, one rank's
    share.

    ``model``/``params``: the whole model and its full weights (the
    same on every rank); the engine keeps only rank ``rank``'s slice
    and builds its own shard of the model.  ``group``: the process
    group of the ``tp`` ranks (``None``: the default group).  Paged KV,
    prefix caching, chunked prefill, preemption and speculative
    decoding pass through ``**kw`` as for the base engine.  ``tp=1``
    runs through a group of one rank and is token-identical to the
    unsharded engine.

        eng = ShardedContinuousBatchingEngine(model, params, tp=4,
                                              rank=rank, max_len=96,
                                              n_slots=4, device="cpu")
        done = eng.serve(requests)       # on every rank, or:
        # rank 0: eng.serve(...) ... eng.close(); others: eng.follow()
    """

    def __init__(self, model, params, *, tp: int, rank: int, group=None,
                 **kw):
        if not dist.is_initialized():
            raise RuntimeError("ShardedContinuousBatchingEngine needs an "
                               "initialised torch.distributed process "
                               "group (repro_torch.parallel.run_tp)")
        # the LM reads a group of None as "no collective"
        group = dist.group.WORLD if group is None else group
        world = dist.get_world_size(group)
        if world != tp or dist.get_rank(group) != rank:
            raise ValueError(f"tp={tp}, rank={rank} but the group has "
                             f"{world} ranks and this is rank "
                             f"{dist.get_rank(group)}")
        cfg = model.cfg
        if tp > 1 and cfg.family == "dense" and cfg.n_kv_heads % tp != 0:
            model, params = replicate_kv_heads(model, params, tp)
            cfg = model.cfg
        local_cfg = tp_local_config(cfg, tp)
        local = type(model)(local_cfg, model.device, kernels=model.kernels,
                            tp_group=group)
        local_params = shard_params(params, model.param_defs(), rank, tp)
        self.tp, self.rank, self.group = tp, rank, group
        self._src = dist.get_global_rank(group, 0)
        # host values travel where the backend moves them: NCCL only
        # moves CUDA tensors, gloo CPU ones
        self._comm_device = (model.device
                             if dist.get_backend(group) == "nccl"
                             else torch.device("cpu"))
        super().__init__(local, local_params, **kw)

    # -- rank 0 drives ----------------------------------------------------
    def _broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def _agreed(self, now: Callable[[], float]) -> Callable[[], float]:
        """A clock that reads rank 0's ``now`` on every rank: each read
        is one broadcast, so every rank sees the same admissions,
        scheduler order and stamps."""
        buf = torch.zeros((), dtype=torch.float64, device=self._comm_device)

        def agreed() -> float:
            if self.rank == 0:
                buf.fill_(float(now()))
            dist.broadcast(buf, src=self._src, group=self.group)
            return float(buf.item())

        return agreed

    def _run(self, cmd, now, sleep) -> list[Request]:
        _, requests, honor_arrivals = cmd
        if self.rank != 0:
            sleep = _no_sleep
        return super().serve(requests, now=self._agreed(now), sleep=sleep,
                             honor_arrivals=honor_arrivals)

    def serve(self, requests=None, now: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep,
              honor_arrivals: bool = True) -> list[Request]:
        """The base ``serve``, run by every rank on rank 0's requests,
        clock and ``honor_arrivals``: rank 0 broadcasts them and the
        other ranks' arguments are not read (their sleeps wait in the
        next clock broadcast instead).  Returns this rank's completed
        requests; every rank emits rank 0's tokens."""
        cmd = self._broadcast(("serve", requests, honor_arrivals)
                              if self.rank == 0 else None)
        if cmd[0] != "serve":
            raise RuntimeError(f"rank {self.rank}: rank 0 sent {cmd[0]!r} "
                               f"while this rank called serve")
        return self._run(cmd, now, sleep)

    def follow(self) -> None:
        """A non-zero rank's loop: serve every request list rank 0's
        ``serve`` sends, until rank 0 calls ``close``."""
        if self.rank == 0:
            raise RuntimeError("rank 0 drives: it serves and closes, "
                               "the other ranks follow")
        while True:
            cmd = self._broadcast(None)
            if cmd[0] == "close":
                return
            self._run(cmd, time.monotonic, _no_sleep)

    def close(self) -> None:
        """Rank 0: end the other ranks' ``follow``."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 closes the sharded engine")
        self._broadcast(("close", None, None))
