"""The train step: loss and gradients by autograd, global-norm clip and
AdamW, with optional gradient accumulation over microbatches (PyTorch
port of the reference ``train/train_step.py``).

  hp = TrainHParams(peak_lr=3e-4, warmup=2, total_steps=6)
  state = init_train_state(model, seed=0, hp=hp)
  step = make_train_step(model, hp)
  state, metrics = step(state, batch)

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(detached copies that require grad), so the state is never changed in
place: a step returns a new ``TrainState`` and leaves the old one as it
was.  The metrics are 0-d tensors on the model's device (``loss``,
``grad_norm``, ``lr`` and the model's own): a step makes no host read.
``train_state_pspecs`` gives the reference's partition specs of the
state under a mesh's rules (``parallel.sharding.make_rules``): the
dry-run reads them for the bytes each device holds, and sharded
training holds its state by them.

Sharded training (``make_train_step(model, hp)`` with ``model`` built on
a ``parallel.grid.Grid``, ``build_model(cfg, grid=grid)``; the step
takes the grid from the model): the state holds this rank's blocks,
a step takes the global batch (each rank uses its data rows of each
microbatch, as the reference splits before it shards), and after the
backward the gradients of leaves replicated over data are summed over
the data group (the loss is each rank's share of the global mean, so the
sum is the mean's gradient); FSDP leaves were reduce-scattered by their
gathers' backward, and leaves replicated over model that see model-split
work (the router, q/k norms) were summed over model by ``copy_to`` and
``gather``.  AdamW then runs on the blocks (``adamw_update``'s
``sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.param import (tree_leaves, tree_map,
                                      tree_unflatten, tree_zip_map)
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update)
from repro_torch.optim.schedule import warmup_cosine


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: Any


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()


def init_train_state(model, seed: int, hp: TrainHParams) -> TrainState:
    """Seeded parameters (``model.init(seed)``: the model's
    ``torch.Generator`` on its device; on a grid each rank draws the
    whole tree and keeps its blocks), zero moments, step 0."""
    params = model.init(seed=seed)
    if getattr(model, "grid", None) is not None:
        params = model.shard(params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return TrainState(params, adamw_init(params, hp.adamw), step)


def _split_micro(batch, n: int) -> list:
    """``batch`` cut along its leading axis into ``n`` equal parts."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n} microbatches")
    return [{k: x.view(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def forward_loss(model, params, batch):
    """(live, loss, metrics): ``model.train_loss`` at ``live``, detached
    copies of ``params``' leaves that require grad; the graph is kept
    for ``backward_grads``."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.train_loss(live, batch)
    return live, loss, metrics


def backward_grads(params, live, loss):
    """The gradients of ``loss`` with respect to ``live``'s leaves, as a
    tree shaped like ``params`` (remat's forwards rerun here); a leaf
    the loss does not use (a VLM's ``patch_proj`` under a tokens-only
    batch) gets zeros, as ``jax.grad`` gives it."""
    leaves = tree_leaves(live)
    with torch.enable_grad():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(params, [torch.zeros_like(t) if g is None else g
                                   for t, g in zip(leaves, grads)])


def _value_and_grad(model, params, batch):
    """((loss, metrics), grads) of ``model.train_loss`` at ``params``;
    everything returned is detached."""
    live, loss, metrics = forward_loss(model, params, batch)
    grads = backward_grads(params, live, loss)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def apply_update(state: TrainState, grads, hp: TrainHParams,
                 sharding=None):
    """The step's learning rate (``warmup_cosine`` at ``state.step``) and
    the AdamW update: (new TrainState, lr, grad norm before clipping).
    ``sharding``: (grid, parameter specs) of a sharded state."""
    lr = warmup_cosine(state.step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                       total=hp.total_steps)
    params, opt, gnorm = adamw_update(state.params, grads, state.opt, lr,
                                      hp.adamw, sharding)
    return TrainState(params, opt, state.step + 1), lr, gnorm


def reduce_over_data(grads, specs, grid):
    """The gradients of the leaves replicated over data (no ``data`` in
    their spec) summed over the grid's data group, in place: one
    all-reduce per dtype over the leaves flattened together."""
    from repro_torch.parallel.collectives import all_reduce_sum
    from repro_torch.parallel.sharding import split_axes
    leaves = [g for g, sp in zip(tree_leaves(grads), tree_leaves(specs))
              if "data" not in split_axes(sp)]
    for dtype in sorted({g.dtype for g in leaves}, key=str):
        same = [g for g in leaves if g.dtype == dtype]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in same]),
                              grid.data_group)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))
    return grads


def make_train_step(model, hp: TrainHParams):
    """Returns step(state, batch) -> (state, metrics): sharded on the
    ``parallel.grid.Grid`` ``model`` was built on (see the module
    docstring), else the one-device step."""
    grid = getattr(model, "grid", None)
    sharding = None if grid is None else (grid, model.pspecs)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if hp.microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device),
                            state.params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for micro in _split_micro(batch, hp.microbatches):
                (loss, _), g = _value_and_grad(model, state.params, micro)
                # the sum and the mean in place: the buffers are the
                # step's own
                tree_zip_map(torch.Tensor.add_, gsum, g)
                del g
                lsum = lsum + loss
            grads = tree_map(lambda g: g.div_(hp.microbatches), gsum)
            loss = lsum / hp.microbatches
            metrics = {"ce": loss}
        else:
            (loss, metrics), grads = _value_and_grad(model, state.params,
                                                     batch)
        if grid is not None:
            grads = reduce_over_data(grads, model.pspecs, grid)
        new, lr, gnorm = apply_update(state, grads, hp, sharding)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return new, out

    return step


def train_state_pspecs(model, rules, hp: TrainHParams) -> TrainState:
    """Partition specs matching ``init_train_state``'s output (the
    reference's ``train_state_pspecs``): the parameters' specs for the
    parameters and both moments, and with int8 moments the per-row
    scales' specs, whose size-1 last dimension cannot stay sharded;
    ``()`` for the steps."""
    from repro_torch.parallel.sharding import logical_pspec, param_pspecs
    pspecs = param_pspecs(model.param_defs(), rules)
    scalar = logical_pspec((), rules)

    def scale_spec(ps):
        return ps if len(ps) == 0 else (*ps[:-1], None)

    if hp.adamw.quant_moments:
        opt = OptState(scalar, pspecs, pspecs, tree_map(scale_spec, pspecs),
                       None)
    else:
        opt = OptState(scalar, pspecs, pspecs)
    return TrainState(pspecs, opt, scalar)
