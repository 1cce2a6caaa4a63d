"""GPipe pipeline parallelism over a ``torch.distributed`` group, one
stage a rank (PyTorch port of the reference ``parallel/pipeline.py``).

Layers are split into S stages; M microbatches stream through them,
activations moving stage to stage by point-to-point ``send``/``recv``
where the reference ``ppermute``s over its ``stage`` mesh axis.  The
schedule is the reference's fill / steady / drain loop: T = M + S - 1
ticks; at tick t stage s runs microbatch t - s when 0 <= t - s < M and
hands its output to stage s + 1.  The bubble fraction is (S - 1) / (M +
S - 1).  The last stage banks the outputs and broadcasts them, so every
rank returns them all (the reference's psum of a one-hot contribution).
The reference's ring also sends the last stage's output back to stage
0, which never reads it; that send is left out.

  f = pipeline_forward(stage_fn, n_stages=S, n_micro=M)
  y = f(this_ranks_stage_params, x_micro)     # on every rank of the group

Launch one rank a stage with ``parallel.launch.run_tp`` (gloo on the
CPU).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def pipeline_forward(stage_fn: Callable, n_stages: int, n_micro: int,
                     group=None):
    """A pipelined forward over ``group`` (default: the whole world),
    whose rank s runs stage s.  ``stage_fn(stage_params, x) -> x`` runs
    one stage's layers on one microbatch, keeping its shape.  Returns
    ``f(stage_params, x_micro)``: ``stage_params`` this rank's stage,
    ``x_micro`` (M, mb, ...) the microbatched input (the same on every
    rank); every rank gets the (M, mb, ...) outputs."""
    def f(stage_params, x_micro):
        if dist.get_world_size(group) != n_stages:
            raise ValueError(f"pipeline_forward: {n_stages} stages on a "
                             f"group of {dist.get_world_size(group)}")
        if x_micro.shape[0] != n_micro:
            raise ValueError(f"pipeline_forward: {x_micro.shape[0]} "
                             f"microbatches, built for {n_micro}")
        stage = dist.get_rank(group)

        def peer(s):
            return s if group is None else dist.get_global_rank(group, s)

        outputs = torch.zeros_like(x_micro)
        inflight = torch.zeros_like(x_micro[0])
        for t in range(n_micro + n_stages - 1):
            mb_id = t - stage
            x_in = x_micro[min(t, n_micro - 1)] if stage == 0 else inflight
            y = stage_fn(stage_params, x_in) if 0 <= mb_id < n_micro \
                else x_in
            if stage == n_stages - 1 and 0 <= mb_id < n_micro:
                outputs[mb_id] = y
            send = None
            if stage < n_stages - 1:
                send = dist.isend(y.contiguous(), peer(stage + 1), group)
            if stage > 0:
                inflight = torch.empty_like(x_micro[0])
                dist.recv(inflight, peer(stage - 1), group)
            if send is not None:
                send.wait()
        dist.broadcast(outputs, peer(n_stages - 1), group)
        return outputs

    return f


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def split_microbatches(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    b = batch.shape[0]
    if b % n_micro:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{n_micro} microbatches")
    return batch.reshape(n_micro, b // n_micro, *batch.shape[1:])
