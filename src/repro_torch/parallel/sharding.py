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
(``parallel.collectives.all_reduce_sum``).  The embeddings, norms and
LM head stay replicated, as ``make_tp_rules`` nulls ``vocab``,
``fsdp``, ``batch`` and ``kv_seq``, so every rank argmaxes the full
logits and sampling needs no gather.

The GSPMD half of the reference module is here too, for the dry-run
(``launch/specs.py``): ``make_rules`` maps a config's logical axes onto
a ``launch.mesh.MeshSpec`` (per mode, with the reference's divisibility
fallbacks and MoE expert candidates), and ``param_pspecs`` /
``pspec_for`` / ``logical_pspec`` give the same partition specs as the
reference, each a plain tuple with one entry a dimension: ``None``, an
axis name or a tuple of them.  ``local_config`` and ``local_shape`` turn
the table into the program one device runs; ``tp_local_config`` is
``local_config`` under a Megatron table of ``tp`` shards.

Logical axes
------------
- ``batch``     data parallelism over ``(pod, data)``
- ``seq_sp``    Megatron-style sequence parallelism (norm/FFN regions)
- ``kv_seq``    sequence-sharded KV cache / flash-decoding split-KV
- ``heads``     tensor parallelism over attention heads
- ``d_ff`` / ``d_inner``  tensor parallelism over FFN / Mamba channels
- ``experts``   expert parallelism (training: model axis)
- ``experts_big``  expert parallelism over the whole mesh (decode EP)
- ``vocab``     vocab-parallel embedding / lm head / cross-entropy
- ``fsdp``      ZeRO-3 style weight sharding over the data axes
- ``stage``     pipeline stage (only on pipeline meshes)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

# the logical dims ``make_tp_rules`` keeps on the tensor-parallel axis
TP_AXES = ("heads", "kv_heads", "heads_flat", "kv_flat", "d_ff")


def tp_local_config(cfg, tp: int):
    """The per-shard view of ``cfg`` under ``tp``-way tensor parallelism:
    ``local_config`` under a table that puts heads, KV heads and FFN
    width on one axis of ``tp`` shards.  Everything a shard computes
    locally (embeddings, norms, lm head) is unchanged.  Raises unless
    the family is dense GQA and all three divide by ``tp``."""
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
    from repro_torch.launch.mesh import make_tp_mesh
    return local_config(cfg, ShardingRules(
        make_tp_mesh(tp), {n: "model" for n in ("heads", "kv_heads",
                                                "d_ff")}, "decode"))


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


# ----------------------------------------------------------------------
# GSPMD rules (the dry-run's): logical axis -> mesh axes
# ----------------------------------------------------------------------
Axis = Union[None, str, tuple[str, ...]]


@dataclasses.dataclass
class ShardingRules:
    """A logical-axis table on a mesh (``launch.mesh.MeshSpec``, or
    ``None``: everything replicated) for one mode."""

    mesh: object
    table: dict
    mode: str = "train"

    def axis_size(self, logical: Optional[str]) -> int:
        ax = self.table.get(logical) if logical else None
        if ax is None or self.mesh is None:
            return 1
        return _size(self.mesh, ax)


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _size(mesh, axes: Axis) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    return math.prod(mesh.shape[a] for a in axes)


def expert_axes(rules: Optional[ShardingRules]) -> Axis:
    """The mesh axes experts are sharded over."""
    if rules is None or rules.mesh is None:
        return None
    return rules.table.get("experts")


def make_rules(cfg, mesh, mode: str = "train") -> ShardingRules:
    """Build the logical->physical table for a config on a mesh.

    ``mode``: "train" | "prefill" | "decode".  Falls back to replication
    for any logical dim whose size does not divide the axis product.
    """
    if mesh is None:
        return ShardingRules(None, {}, mode)
    dp = _dp_axes(mesh)
    tp_axis = "model" if "model" in mesh.axis_names else None

    def fits(n: int, ax: Axis) -> Axis:
        return ax if ax is not None and n % _size(mesh, ax) == 0 else None

    table: dict = {
        "batch": dp if dp else None,
        "seq_sp": tp_axis if mode in ("train", "prefill") else None,
        "kv_seq": tp_axis if cfg.seq_shard_kv else None,
        "heads": fits(cfg.n_heads, tp_axis),
        "kv_heads": fits(cfg.n_kv_heads, tp_axis),
        "heads_flat": fits(cfg.n_heads, tp_axis),
        "kv_flat": fits(cfg.n_kv_heads, tp_axis),
        "d_ff": fits(cfg.d_ff, tp_axis),
        "d_expert": None,
        "vocab": tp_axis,     # vocab is padded to a multiple of 2048
        "embed": None,
        "fsdp": dp if (dp and (mode == "train" or
                               (mode == "prefill" and cfg.prefill_fsdp)))
        else None,
        "experts": None,
        "experts_big": None,
        "d_inner": None,
        "rwkv_heads": None,
        "stage": "stage" if "stage" in mesh.axis_names else None,
    }
    if cfg.moe is not None:
        table["experts"] = fits(cfg.moe.n_experts, tp_axis)
        # decode-time EP: widest axis set that divides n_experts, so the
        # big expert stacks (deepseek: 256e) spread over the whole mesh
        candidates: list = []
        if dp and tp_axis:
            candidates.append(dp + (tp_axis,))
        if "data" in mesh.axis_names and tp_axis:
            candidates.append(("data", tp_axis))
        candidates.append(tp_axis)
        table["experts_big"] = table["experts"]
        if mode == "decode":
            for cand in candidates:
                if cand is not None and \
                        cfg.moe.n_experts % _size(mesh, cand) == 0:
                    table["experts_big"] = cand
                    table["experts"] = cand
                    break
    if cfg.mamba is not None:
        table["d_inner"] = fits(cfg.mamba.expand * cfg.d_model, tp_axis)
    if cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import padded_heads
        table["rwkv_heads"] = fits(padded_heads(cfg), tp_axis)
    return ShardingRules(mesh, table, mode)


def logical_pspec(names: Sequence[Optional[str]],
                  rules: Optional[ShardingRules]) -> tuple:
    """The partition spec of logical ``names``: one entry a dimension,
    each mesh axis used at most once (the first dimension naming it
    takes it), a one-axis tuple written as the axis (as
    ``jax.sharding.PartitionSpec`` normalises it).  ``()`` without a
    mesh."""
    if rules is None or rules.mesh is None:
        return ()
    used: set[str] = set()
    dims = []
    for name in names:
        ax = rules.table.get(name) if name else None
        if ax is None:
            dims.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(a in used for a in axes):
            dims.append(None)
            continue
        used.update(axes)
        dims.append(axes[0] if len(axes) == 1 else axes)
    return tuple(dims)


def _fit_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop axes that do not divide the dimension (GSPMD-uneven guard)."""
    dims = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            dims.append(None)
            continue
        dims.append(ax if shape[i] % _size(mesh, ax) == 0 else None)
    return tuple(dims)


def pspec_for(shape: tuple[int, ...], names: Sequence[Optional[str]],
              rules: Optional[ShardingRules]) -> tuple:
    """Divisibility-validated partition spec for a concrete shape."""
    if rules is None or rules.mesh is None:
        return ()
    return _fit_spec(logical_pspec(names, rules), shape, rules.mesh)


def param_pspecs(defs, rules: Optional[ShardingRules]):
    """Map a nested dict of ``ParamDef`` to (shape-validated) specs."""
    from repro_torch.models.param import tree_map
    return tree_map(lambda d: pspec_for(d.shape, d.names, rules), defs)


def shard_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """The shape of the shard one device holds of a leaf of ``shape``
    under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // (_size(mesh, ax) if ax is not None else 1)
                 for n, ax in zip(shape, spec))


def shard_bytes(shape: tuple[int, ...], itemsize: int, spec: tuple,
                mesh) -> int:
    """Bytes one device holds of a leaf of ``shape`` under ``spec``."""
    return math.prod(shard_shape(shape, spec, mesh)) * itemsize


# the logical dims a device computes a share of (``local_shape``);
# ``fsdp`` shards are gathered before use and ``kv_seq`` is not split
LOCAL_DIMS = ("batch", "heads", "kv_heads", "heads_flat", "kv_flat", "d_ff",
              "vocab", "experts", "d_inner", "rwkv_heads")


def local_shape(shape: tuple[int, ...], names: Sequence[Optional[str]],
                rules: Optional[ShardingRules]) -> tuple[int, ...]:
    """The shape one device computes with of a tensor of ``shape`` and
    logical ``names``: each ``LOCAL_DIMS`` dimension the table maps to
    mesh axes, and that they divide, divided by their size (each mesh
    axis once, as ``logical_pspec`` takes it); every other dimension
    whole (an ``fsdp`` weight is all-gathered over the data axes before
    use, a ``kv_seq`` cache keeps its rows)."""
    local = [n if n in LOCAL_DIMS else None for n in names]
    spec = pspec_for(shape, local, rules)
    return shard_shape(shape, spec, rules.mesh) if spec else tuple(shape)


def local_config(cfg, rules: Optional[ShardingRules]):
    """The config of the program one device runs under ``rules``: query
    heads, KV heads and FFN width divided by the size of the mesh axes
    the table maps them to, each left whole where the table replicates
    it (8 KV heads on a model axis of 16, say: the dry-run's program
    then keeps the KV heads its query heads attend, ``launch.specs``'
    ``program_config``).  ``d_head`` is pinned, since ``d_model // n_heads``
    would change.  Widths the config cannot express (a share of the
    experts, the vocabulary, Mamba channels or RWKV heads) are the
    local parameters' shapes (``local_shape``), which the layers read."""
    if rules is None or rules.mesh is None:
        return cfg
    h, kvh, ff = (rules.axis_size(n) for n in ("heads", "kv_heads", "d_ff"))
    if h == kvh == ff == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // h,
                               n_kv_heads=cfg.n_kv_heads // kvh,
                               d_ff=cfg.d_ff // ff, d_head=cfg.head_dim)


# ----------------------------------------------------------------------
# Sharded training: each rank's slices of a tree under the specs
# ----------------------------------------------------------------------
def _axes(ax: Axis) -> tuple:
    return () if ax is None else ((ax,) if isinstance(ax, str) else
                                  tuple(ax))


def block_index(ax: Axis, mesh, coords: dict) -> int:
    """Row-major index of ``coords`` over the mesh axes ``ax`` (the
    order of a tuple of axes in a partition spec)."""
    idx = 0
    for a in _axes(ax):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def shard_leaf(t: torch.Tensor, spec: tuple, mesh,
               coords: dict) -> torch.Tensor:
    """The block of the full leaf ``t`` that the device at ``coords``
    ({axis: index}) holds under ``spec``, as an owned copy."""
    out = t
    for dim, ax in enumerate(spec):
        n = _size(mesh, ax)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {ax!r} ({n})")
        step = t.shape[dim] // n
        out = out.narrow(dim, block_index(ax, mesh, coords) * step, step)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, pspecs, mesh, coords: dict):
    """Each leaf of ``tree`` (full tensors) cut to the block the device
    at ``coords`` holds under the matching spec of ``pspecs`` (the
    reference's ``param_pspecs(defs, make_rules(cfg, mesh, "train"))``:
    the dry-run's table, so there is one layout)."""
    from repro_torch.models.param import tree_zip_map
    return tree_zip_map(lambda t, s: shard_leaf(t, s, mesh, coords),
                        tree, pspecs)


def gather_leaf(t: torch.Tensor, spec: tuple, grid) -> torch.Tensor:
    """The full leaf rebuilt from every rank's block (no gradient):
    an all-gather over each mesh axis that splits it, the last axis of
    a tuple first, so that the blocks land in row-major order."""
    from repro_torch.parallel.collectives import all_gather_nograd
    for dim, ax in enumerate(spec):
        for a in reversed(_axes(ax)):
            t = all_gather_nograd(t, dim, grid.group(a))
    return t


def gather_tree(tree, pspecs, grid):
    """``shard_tree``'s inverse on a grid: every leaf whole on every
    rank (checkpoints, tests)."""
    from repro_torch.models.param import tree_zip_map
    return tree_zip_map(lambda t, s: gather_leaf(t, s, grid), tree, pspecs)


def gather_fsdp(tree, pspecs, grid):
    """Each leaf with its data-axis (FSDP) dimensions all-gathered over
    the grid's data group, differentiably: the gradient comes back
    reduce-scattered, summed over the data ranks.  Dimensions split
    over the model axis stay split (tensor and expert parallelism)."""
    from repro_torch.models.param import tree_zip_map
    from repro_torch.parallel.collectives import gather

    def one(t, spec):
        for dim, ax in enumerate(spec):
            if "data" in _axes(ax):
                if _axes(ax) != ("data",):
                    raise NotImplementedError(
                        f"FSDP over {ax!r}: train meshes are (data, model)")
                t = gather(t, dim, grid.data_group)
        return t

    return tree_zip_map(one, tree, pspecs)


def split_axes(spec: tuple) -> set:
    """The mesh axes a leaf of partition ``spec`` is split over."""
    return {a for ax in spec for a in _axes(ax)}


class Shard:
    """A restore target's layout (the reference's ``NamedSharding``):
    ``Shard(spec, mesh, coords)(full)`` is the block of ``full`` that
    the device at ``coords`` holds."""

    def __init__(self, spec: tuple, mesh, coords: dict):
        self.spec, self.mesh, self.coords = tuple(spec), mesh, dict(coords)

    def __call__(self, full: torch.Tensor) -> torch.Tensor:
        return shard_leaf(full, self.spec, self.mesh, self.coords)


def shardings(specs, mesh, coords: dict):
    """A tree of ``Shard`` matching a tree of partition specs (dicts and
    NamedTuples such as ``train_state_pspecs``'; a spec tuple is a leaf,
    ``None`` stays ``None``): ``CheckpointManager.restore``'s
    ``shardings`` for the device at ``coords``."""
    if specs is None:
        return None
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(shardings(getattr(specs, n), mesh, coords)
                             for n in specs._fields))
    if isinstance(specs, dict):
        return {k: shardings(v, mesh, coords) for k, v in specs.items()}
    return Shard(specs, mesh, coords)
