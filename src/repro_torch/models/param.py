"""Single-source parameter definitions (PyTorch port).

A model declares its parameters as a nested dict of ``ParamDef`` (shape
+ logical axis names + init), as in the JAX package; ``init_params``
turns that tree into tensors with the same init rules, drawn from an
explicit ``torch.Generator``.  ``from_jax`` takes the reference
package's parameter tree (as numpy arrays) so both stacks can run on
the same weights.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class ParamDef(NamedTuple):
    shape: tuple[int, ...]
    names: tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | embed | small
    dtype: str = "bfloat16"
    scale: Optional[float] = None   # stddev override


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict shaped like ``like`` holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(like)


def tree_zip_map(fn, *trees):
    """``fn`` over the matching leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_zip_map(fn, *(t[k] for t in trees))
                for k in trees[0]}
    return fn(*trees)


# the largest float32 temporary a leaf's draw may take
SLICE_BYTES = 1 << 30


def _draw_normal(shape, std: float, dtype, gen) -> torch.Tensor:
    """A normal(0, std) tensor of ``shape``, drawn in float32 and cast to
    ``dtype``.  A leaf whose float32 draw would pass ``SLICE_BYTES`` is
    drawn one block of slices at a time (slices of the leading axis, or
    of the first axes whose slices fit), so that no temporary passes it:
    qwen3-moe's stacked expert weights are 38.7 GB in float32, beside
    the 61 GB of bf16 weights on an 80 GB card."""
    dev = gen.device
    if math.prod(shape) * 4 <= SLICE_BYTES:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(dtype)
    lead = 1
    while math.prod(shape[lead:]) * 4 > SLICE_BYTES:
        lead += 1
    inner = shape[lead:]
    out = torch.empty(shape, dtype=dtype, device=dev)
    rows = out.view(-1, *inner)
    step = max(1, SLICE_BYTES // (math.prod(inner) * 4))
    for i in range(0, rows.shape[0], step):
        blk = rows[i:i + step]
        x = torch.randn(blk.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        blk.copy_(x.mul_(std))
    return out


def _init_one(d: ParamDef, gen: torch.Generator) -> torch.Tensor:
    dtype = DTYPES[d.dtype]
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    if d.init == "embed":
        std = d.scale or 0.02
    elif d.init == "small":
        std = d.scale or 1e-3
    else:                           # fan-in scaled normal
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale or (1.0 / math.sqrt(max(1, fan_in)))
    return _draw_normal(d.shape, std, dtype, gen)


def init_params(defs, gen: torch.Generator):
    """Real parameters for a ``ParamDef`` tree, on ``gen.device``.

    Leaves are drawn in sorted-key order from one generator.  The
    numbers differ from ``jax.random`` for the same seed; tests that
    need both stacks on the same weights use ``from_jax``.
    """
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return _init_one(tree, gen)

    return walk(defs)


def stacked(d: ParamDef, n: int) -> ParamDef:
    """Prepend a layer dimension."""
    return d._replace(shape=(n,) + d.shape, names=(None,) + d.names)


def stack_tree(defs, n: int):
    return tree_map(lambda d: stacked(d, n), defs)


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                  # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: same 16 bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax(params_np, device="cuda"):
    """The reference package's parameter tree -> the port's tensors.

    ``params_np`` is the JAX tree with every leaf converted to numpy
    (``jax.tree.map(np.asarray, params)``).  bfloat16 leaves arrive as
    ``ml_dtypes`` arrays and are reinterpreted bit for bit through
    uint16, so no value is rounded on the way.
    """
    return tree_map(lambda a: _to_tensor(a).to(device), params_np)
