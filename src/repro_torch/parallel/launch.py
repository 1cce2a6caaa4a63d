"""One process per tensor-parallel shard (the counterpart of the
reference ``launch/mesh.py:make_tp_mesh``).

The reference shards one process's devices with a 1-D mesh; the port
runs ``tp`` processes instead, one rank each, joined by
``torch.distributed``: NCCL on the card (rank ``r`` on ``cuda:r``),
gloo on the CPU (one intra-op thread a rank, so that the ranks do not
oversubscribe the cores).  The ranks meet through a rendezvous file in
a fresh temporary directory, never a fixed TCP port, so that several
groups can start at once on one machine.

  run_tp(fn, 4, backend="gloo", timeout_s=120, args=(...,))

calls ``fn(rank, tp, *args)`` on every rank inside its process group
and returns rank 0's result; ``run_grid(fn, data, model, ...)`` runs
``data * model`` ranks the same way and calls ``fn(grid, *args)`` with
each rank's ``parallel.grid.Grid`` (its coordinates and the groups of
its data row and model column) (``fn`` and ``args`` must pickle: ``fn`` a
module-level function; results plain data, not tensors).  A rank that
raises, a rank that dies and a collective that hangs all end
``run_tp`` within ``timeout_s``: every rank is killed and the error
(the failing rank's traceback, or which ranks had not finished)
raised.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

# seconds a rank gets to exit after its result arrived
_EXIT_GRACE_S = 30.0


def _rank_main(fn, rank: int, tp: int, backend: str, timeout_s: float,
               rdzv: str, args: tuple, results) -> None:
    """Body of one rank's process: join the group, run ``fn``, report."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{rdzv}", rank=rank,
            world_size=tp, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, tp, *args)
    except BaseException:
        # report before any teardown: a peer may still wait in a
        # collective, and the parent kills the group on this message
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()
    results.put((rank, True, out if rank == 0 else None))


def _on_grid(rank: int, tp: int, fn, data: int, model: int, *args):
    """``run_grid``'s body on one rank: ``fn(grid, *args)``."""
    from repro_torch.parallel.grid import Grid
    dev = f"cuda:{rank}" if dist.get_backend() == "nccl" else "cpu"
    return fn(Grid(data, model, device=dev), *args)


def run_grid(fn: Callable[..., Any], data: int, model: int, *,
             backend: str = "gloo", timeout_s: float = 300.0,
             args: tuple = ()) -> Any:
    """``run_tp`` over a ``data`` x ``model`` grid of ranks: calls
    ``fn(grid, *args)`` on each (``grid`` its ``parallel.grid.Grid``) and
    returns rank 0's result, with ``run_tp``'s errors and timeout."""
    if data < 1 or model < 1:
        raise ValueError(f"grid {data} x {model}")
    return run_tp(_on_grid, data * model, backend=backend,
                  timeout_s=timeout_s, args=(fn, data, model, *args))


def run_tp(fn: Callable[..., Any], tp: int, *, backend: str = "gloo",
           timeout_s: float = 300.0, args: tuple = ()) -> Any:
    """Run ``fn(rank, tp, *args)`` on ``tp`` spawned ranks of one
    process group and return rank 0's result.  ``backend``: ``"gloo"``
    (CPU) or ``"nccl"`` (rank r on ``cuda:r``; raises when fewer than
    ``tp`` cards are visible).  Raises ``RuntimeError`` with the first
    failing rank's traceback, or ``TimeoutError`` when the ranks have
    not all finished ``timeout_s`` seconds after the start; in both
    cases every rank is killed first."""
    if tp < 1:
        raise ValueError(f"tp={tp} < 1")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo (CPU) or nccl (CUDA)")
    if backend == "nccl" and tp > torch.cuda.device_count():
        raise ValueError(f"tp={tp} ranks need {tp} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro-tp-")
    rdzv = os.path.join(tmp, "rdzv")
    procs = [ctx.Process(target=_rank_main, name=f"tp-rank-{r}",
                         args=(fn, r, tp, backend, timeout_s, rdzv, args,
                               results), daemon=True)
             for r in range(tp)]
    deadline = time.monotonic() + timeout_s
    done: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(done) < tp:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(tp)) - set(done))
                raise TimeoutError(
                    f"run_tp: ranks {missing} of {tp} did not finish "
                    f"within {timeout_s} s (a hung collective, or a "
                    f"peer that never reached it)")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    # a last message may still be in the pipe
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"run_tp: rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode} and no report")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"run_tp: rank {rank} of {tp} raised:\n"
                                   f"{out}")
            done[rank] = out
        for p in procs:
            p.join(timeout=max(0.0, min(_EXIT_GRACE_S,
                                        deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return done[0]
