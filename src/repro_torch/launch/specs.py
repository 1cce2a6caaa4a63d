"""Input specifications and the per-device program of every (architecture
x shape x mesh) cell (PyTorch port of ``launch/specs.py``).

``input_specs`` gives ``meta`` tensors of the reference's shapes and
dtypes for every model input (the vlm's ``patch_embeds``, the encdec's
``frames``), ``input_pspecs`` their partition specs.  ``build_cell``
assembles one cell: the step (``LM.prefill``, ``LM.decode_step`` with
one token against a full-length cache, or ``train.make_train_step``),
its arguments, their partition specs and the collectives the layout
implies.  Without a mesh the cell is the whole program on one device,
and with ``device="cuda"`` it runs for real on seeded weights; on a
mesh it runs on ``meta``, where ``launch.opcount`` counts it.

The per-device program.  Under a mesh the cell counts the program one
device runs under the rules table (``parallel.sharding``):

* the batch is divided by the sizes of its mesh axes;
* each logical dimension the table maps to mesh axes among ``heads``,
  ``kv_heads``, ``heads_flat``, ``kv_flat``, ``d_ff``, ``vocab``,
  ``experts``, ``d_inner`` and ``rwkv_heads`` is divided by their size
  (``local_shape``); a dimension the table replicates stays whole;
* the config the layers read is ``local_config`` (heads and FFN width
  divided alike); the parameters are the global ones' local shapes;
* KV heads the table replicates while it shards the query heads
  (qwen3-1.7b's 8 KV heads on a model axis of 16, with one query head
  a device): the device projects all of them but attends only those of
  its query heads' groups.  The program run here projects and caches
  those (``program_config``, ``program_shape``: one KV head for every
  assigned arch, whose groups hold a device's query heads whole), so
  the layers keep their GQA shapes; the projection of the others, two
  products a layer and pass, is counted apart (``unattended_kv_work``,
  in ``count_cell``);
* ``fsdp`` weights are all-gathered before use, so the program sees
  them whole, and the MoE router (which the reference replicates
  inside its expert-parallel ``shard_map``: routing needs every
  expert's score) is whole;
* the program does not split the sequence (``seq_sp``, ``kv_seq``): a
  device runs its batch share's whole sequence through its heads' (or
  channels') share of each layer, and a decode cell reads the KV rows of
  its own heads over the whole cache, where the reference reads all
  heads over its sequence shard.  The reference's train and prefill
  programs split the sequence between blocks (``seq_sp``, Megatron
  sequence parallelism) and run the FFN, the norms and half of the
  attention's projections on a device's sequence shard with those
  weights whole: the same FLOPs (its dot FLOPs equal this program's:
  ``tests/test_torch_dryrun.py``), other bytes (whole weights, a shard of
  the tokens), which this program does not count (ROADMAP §C.5).  The
  collectives follow ``seq_sp`` all the same (``collective_records``).
  A decode cell's cache bytes agree unless the KV heads are replicated
  (then a device here reads those its query heads use).

Families counted otherwise than at a smaller config:

* MoE (moe, mla_moe, hybrid's MoE layers): the local program holds its
  share of the experts (E / ep weight stacks) and routes its tokens over
  all E with the whole router; ``_moe_local`` sizes its buffer by the
  local stacks, so a device computes E / ep experts x capacity(its
  tokens) rows, which is what the reference's all-to-all expert
  parallelism gives a device (E / ep experts over ep peers' capacity
  rows, each peer holding 1 / ep of the tokens).  At decode, where the
  experts may spread over the data axes as well, each device's experts
  see the capacity rows of its own batch share (the reference gathers
  every token; a few rows at decode).
* MLA: the absorbed projections are per-head weights (``wq_b``,
  ``wk_b``, ``wv_b`` by ``heads``), so a device runs its heads' share;
  the latent cache (no head axis) is whole.
* RWKV-6 and Mamba: their layers read the local weights' widths (the
  padded heads of ``w_r``, the channels of ``in_proj``), so a device
  runs its share of the heads or channels.

What a device holds is another matter: ``Cell.arg_bytes`` is the bytes
of the arguments' shards under their partition specs (the reference's
``memory_analysis().argument_size_in_bytes``), not the local program's
arguments, which are gathered (``fsdp``, the router) or whole
(``kv_seq``).  ``Cell.records`` are the collectives the plan implies
(``collective_records``), which ``launch/roofline.py`` costs.

The collective plan's evidence.  Where ``seq_sp`` splits the sequence,
a layer's activation collectives are the tables ``_GQA``, ``_GQA_CORE``,
``_MLA`` and ``_MAMBA`` and the Mamba mixer's collective-permutes by
model axis (``_mamba_permutes``), read from the reference's compiled
train and prefill steps: one layer's collectives are the difference of
two depths, counted by (kind, operand shape).  They were read at 8 x 64
on a (2, 2) host mesh, ``kv_part`` (KV heads dividing the model axis
without filling it, which no model axis of 2 has) on a (2, 4) one, and
the Mamba permutes at model axes of 2, 4, 8 and 16; a (2, 8) mesh,
which no attention layout was read from, holds them
(``tests/test_torch_collective_plan.py``,
``tests/test_torch_collective_plan_mesh24.py``), and so do the
dry-run's own GQA prefill cells, at full width on the (16, 16) mesh
(``tests/test_torch_collective_plan_real.py``).  ``unchecked_layout``
names what no such program holds: the backward of attention over
several query chunks (every train cell: the plan leaves it out), MLA
over several chunks, the Mamba permutes at other model axes or shorter
shards, the choice between ``kv_on_seq`` and ``x_gathered``, a query
wider a device than the model with split or dividing KV heads, rwkv6
and the encoder-decoder (ROADMAP §C.4, §C.5); the plan gives those
cells the nearest layout's records, marked (``Cell.unchecked``, the
dry-run report's ``collectives_unchecked``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.models.param import DTYPES
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import (ShardingRules, _fit_spec,
                                           local_config, local_shape,
                                           make_rules, param_pspecs,
                                           pspec_for, shard_bytes,
                                           shard_shape)
from repro_torch.train.train_step import (TrainHParams, TrainState,
                                          make_train_step,
                                          train_state_pspecs)

# each input's logical axes (the reference's ``input_pspecs``)
INPUT_NAMES = {"tokens": ("batch", "seq_sp"), "labels": ("batch", "seq_sp"),
               "patch_embeds": ("batch", None, None),
               "frames": ("batch", "seq_sp", None)}


def _input_shapes(cfg: ModelConfig, shape: ShapeConfig,
                  batch: int) -> dict:
    """name -> (shape, dtype) of one cell's data inputs at ``batch``."""
    s = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((batch, 1), torch.int32)}
    out = {"tokens": ((batch, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = ((batch, s), torch.int32)
    if cfg.vlm is not None:
        n_p = cfg.vlm.n_patches
        pe_d = cfg.vlm.patch_embed_dim or cfg.d_model
        out["tokens"] = ((batch, s - n_p), torch.int32)
        if "labels" in out:
            out["labels"] = ((batch, s - n_p), torch.int32)
        out["patch_embeds"] = ((batch, n_p, pe_d), torch.float32)
    if cfg.family == "encdec":
        out["frames"] = ((batch, cfg.encdec.enc_len, cfg.d_model),
                         torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """Empty tensors of the *data* inputs of one cell (``meta`` by
    default: no storage), at the reference's shapes and dtypes."""
    return {k: torch.empty(s, dtype=dt, device=device)
            for k, (s, dt) in _input_shapes(cfg, shape,
                                            shape.global_batch).items()}


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 rules: ShardingRules) -> dict:
    return {k: pspec_for(s, INPUT_NAMES[k], rules)
            for k, (s, _) in _input_shapes(cfg, shape,
                                           shape.global_batch).items()}


def _fit_cache(cache_ps, cache_abs, mesh):
    """Validate cache pspecs against the concrete cache tensors."""
    if mesh is None:
        return cache_ps
    if isinstance(cache_ps, dict):
        return {k: _fit_cache(cache_ps[k], cache_abs[k], mesh)
                for k in cache_ps}
    return _fit_spec(cache_ps, tuple(cache_abs.shape), mesh)


def zip_leaves(tensors, specs):
    """(tensor, spec) pairs of two trees of one structure (dicts, tuples
    such as ``TrainState``; ``None`` entries have no leaves), walked by
    the tensor tree."""
    if tensors is None:
        return
    if isinstance(tensors, dict):
        for k in tensors:
            yield from zip_leaves(tensors[k], specs[k])
    elif isinstance(tensors, (tuple, list)):
        for t, s in zip(tensors, specs):
            yield from zip_leaves(t, s)
    else:
        yield tensors, specs


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) cell: ``fn(*args)`` is the program one
    device runs; ``global_args`` (meta tensors) and ``arg_pspecs`` the
    arguments of the whole program and their partition specs;
    ``records`` the implied collectives as (kind, result bytes, group
    size); ``apart`` work the device does that ``fn`` leaves out, as
    (name, flops, bytes), which ``count_cell`` adds; ``unchecked`` why
    ``records`` has no compiled program of the reference behind it, or ""
    (``unchecked_layout``)."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    rules: ShardingRules
    model: Any
    fn: Callable
    args: tuple
    global_args: tuple
    arg_pspecs: tuple
    records: list
    apart: list = dataclasses.field(default_factory=list)
    unchecked: str = ""

    @property
    def n_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def arg_bytes(self) -> int:
        """Bytes one device holds of the arguments, under their specs."""
        return sum(shard_bytes(tuple(t.shape), t.element_size(), s,
                               self.mesh) if self.mesh is not None
                   else t.numel() * t.element_size()
                   for t, s in zip_leaves(self.global_args,
                                          self.arg_pspecs))

    def run(self):
        return self.fn(*self.args)


def _walk_defs(defs, make, path=()):
    """``make(path, def)`` over a nested dict of ``ParamDef``."""
    if isinstance(defs, dict):
        return {k: _walk_defs(v, make, path + (k,)) for k, v in defs.items()}
    return make(path, defs)


def compute_names(path: tuple, names: tuple) -> tuple:
    """The logical names a parameter is computed with: the MoE router's
    experts axis is gathered (routing needs every expert's score)."""
    if path and path[-1] == "router":
        return tuple(None if n == "experts" else n for n in names)
    return names


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def program_config(cfg: ModelConfig, rules: ShardingRules) -> ModelConfig:
    """``local_config``, but with the KV heads a device's query heads
    attend where the table shards the query heads and replicates the
    KV heads (one KV head a group of ``n_heads / n_kv_heads`` query
    heads): the config the dry-run's program runs with."""
    lcfg = local_config(cfg, rules)
    if cfg.mla is not None or lcfg.n_kv_heads != cfg.n_kv_heads:
        return lcfg
    group = cfg.n_heads // cfg.n_kv_heads
    attended = max(1, lcfg.n_heads // group)
    if attended >= lcfg.n_kv_heads:
        return lcfg
    return dataclasses.replace(lcfg, n_kv_heads=attended)


def program_shape(shape: tuple[int, ...], names, rules: ShardingRules,
                  pcfg: ModelConfig) -> tuple[int, ...]:
    """``local_shape``, with ``kv_heads`` (``kv_flat``) at
    ``pcfg.n_kv_heads`` (times the head dim) KV heads, where it is
    ``pcfg``'s attended count (``program_config``)."""
    out = list(local_shape(shape, names, rules))
    for i, n in enumerate(names):
        if n == "kv_heads" and out[i] > pcfg.n_kv_heads:
            out[i] = pcfg.n_kv_heads
        elif n == "kv_flat" and out[i] > pcfg.n_kv_heads * pcfg.head_dim:
            out[i] = pcfg.n_kv_heads * pcfg.head_dim
    return tuple(out)


def unattended_kv_work(cfg: ModelConfig, shape: ShapeConfig,
                       rules: ShardingRules, model) -> list:
    """The K and V projections of the replicated KV heads a device
    computes but does not attend, which the program of
    ``program_config`` leaves out: per attention layer two products of
    the device's tokens (T x d) by the other heads' columns (d x e),
    each 2 T d e FLOPs and T d + d e + T e elements moved, once at
    prefill and decode, three times in training (the forward product
    and the two of its backward pass) and four under remat, but three
    under ``remat_policy="dots"``, which saves the product (the encdec
    has no such policy).  An encdec
    projects over the decoder's tokens in its decoder layers and, but
    at decode (the cross K/V are cached), over the frames in its
    encoder layers and its cross-attention.  Their bias adds, rope and
    cache writes (one element each) are not counted.  Returns [(name,
    flops, bytes)]."""
    lcfg, pcfg = local_config(cfg, rules), model.cfg
    e = (lcfg.n_kv_heads - pcfg.n_kv_heads) * cfg.head_dim
    if e <= 0:
        return []
    it, d = DTYPES[cfg.dtype].itemsize, cfg.d_model
    batch = local_shape((shape.global_batch,), ("batch",), rules)[0]
    decode = shape.kind == "decode"
    t = batch * (1 if decode else shape.seq_len)
    if cfg.family == "encdec":
        frames = batch * cfg.encdec.enc_len
        runs = [(cfg.n_layers, t)] + ([] if decode else [
            (cfg.n_layers + cfg.encdec.enc_layers, frames)])
    else:
        runs = [(sum(k.startswith("attn") for k in model._layer_kinds()),
                 t)]
    passes = 1
    if shape.kind == "train":
        passes = 4 if cfg.remat and (cfg.remat_policy == "nothing"
                                     or cfg.family == "encdec") else 3
    flops = nbytes = 0
    for layers, tok in runs:
        n = 2 * layers * passes
        flops += n * 2 * tok * d * e
        nbytes += n * it * (tok * d + d * e + tok * e)
    return [("unattended_kv_proj", flops, nbytes)]


def _cache_tree(specs, names, make, shape_of, path=""):
    if isinstance(specs, dict):
        return {k: _cache_tree(specs[k], names[k], make, shape_of,
                               f"{path}/{k}") for k in specs}
    shape, dtype = specs
    return make(shape_of(shape, names), dtype, path)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               hp: Optional[TrainHParams] = None, device="meta",
               seed: int = 0) -> Cell:
    """The cell of ``cfg`` at ``shape`` on ``mesh`` (a
    ``launch.mesh.MeshSpec`` or ``None``).  ``device="meta"`` builds
    every argument without storage; another device (``mesh=None``
    only) draws the weights from ``seed`` (``model.init``), the tokens
    and float inputs from a generator seeded ``seed + 1`` and a zero
    cache at ``pos = seq_len - 1``."""
    dev = torch.device(device)
    meta = dev.type == "meta"
    if mesh is not None and not meta:
        raise ValueError("a cell on a mesh is one device's program; it "
                         "runs on meta only")
    mode = shape.kind
    rules = make_rules(cfg, mesh, mode)
    pcfg = program_config(cfg, rules)
    gmodel = build_model(cfg, "meta")
    model = build_model(pcfg, dev)
    defs = gmodel.param_defs()

    global_params = _walk_defs(
        defs, lambda p, d: _empty(d.shape, DTYPES[d.dtype]))
    if meta:
        params = _walk_defs(defs, lambda p, d: _empty(
            program_shape(d.shape, compute_names(p, d.names), rules, pcfg),
            DTYPES[d.dtype]))
    else:
        params = model.init(seed=seed)
    model.vp = params["embed"].shape[0]     # a device's share of the vocab
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed + 1)
    batch = local_shape((shape.global_batch,), ("batch",), rules)[0]

    def data(s, dt):
        if meta:
            return _empty(s, dt)
        if dt == torch.int32:
            return torch.randint(0, cfg.vocab_size, s, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.randn(s, generator=gen, device=dev, dtype=dt)

    inputs = {k: data(s, dt)
              for k, (s, dt) in _input_shapes(cfg, shape, batch).items()}
    g_inputs = input_specs(cfg, shape)
    in_ps = input_pspecs(cfg, shape, rules)
    records = collective_records(cfg, shape, rules, model, defs)
    unchecked = unchecked_layout(cfg, shape, rules, model)
    apart = unattended_kv_work(cfg, shape, rules, model)

    def local_cache(s, n):
        return program_shape(s, n, rules, pcfg)

    if shape.kind == "train":
        hp = hp or TrainHParams()
        step = torch.zeros((), dtype=torch.int32, device=dev)
        g_state = TrainState(global_params, adamw_init(global_params,
                                                       hp.adamw),
                             _empty((), torch.int32))
        state_ps = train_state_pspecs(gmodel, rules, hp)
        held = params
        if meta and mesh is not None:
            # the shards a device holds (ZeRO-3: fsdp over the data axes)
            held = _walk_defs(defs, lambda p, d: _empty(
                shard_shape(d.shape, pspec_for(d.shape, d.names, rules),
                            mesh), DTYPES[d.dtype]))
        state = TrainState(held, adamw_init(held, hp.adamw), step)
        fn = (make_train_step(model, hp) if held is params
              else fsdp_train_step(model, hp, params))
        return Cell(cfg, shape, mesh, rules, model, fn,
                    (state, inputs), (g_state, g_inputs),
                    (state_ps, in_ps), records, apart, unchecked)

    params_ps = param_pspecs(defs, rules)
    if shape.kind == "prefill":
        def prefill_fn(p, x):
            if cfg.family == "encdec":
                return model.prefill(p, x)
            # the cache a prefill allocates, at the local widths (a
            # local config cannot express a share of the Mamba
            # channels or RWKV heads)
            specs = gmodel.cache_specs(shape.global_batch, shape.seq_len)
            cache = _cache_tree(specs, gmodel.cache_names(),
                                lambda s, dt, _: torch.zeros(s, dtype=dt,
                                                             device=dev),
                                local_cache)
            return model.prefill(p, x, cache=cache["layers"])

        return Cell(cfg, shape, mesh, rules, model, prefill_fn,
                    (params, inputs), (global_params, g_inputs),
                    (params_ps, in_ps), records, apart, unchecked)

    # decode: one token against a full-length cache
    specs = gmodel.cache_specs(shape.global_batch, shape.seq_len)
    names = gmodel.cache_names()
    pos = shape.seq_len - 1

    def make(s, dt, path):
        if meta:
            return _empty(s, dt)
        if path == "/pos":
            return torch.full(s, pos, dtype=dt, device=dev)
        return torch.zeros(s, dtype=dt, device=dev)

    cache = _cache_tree(specs, names, make, local_cache)
    g_cache = _cache_tree(specs, names, lambda s, dt, _: _empty(s, dt),
                          lambda s, n: s)
    cache_ps = _fit_cache(gmodel.cache_pspecs(rules), g_cache, mesh)

    def decode_fn(p, c, tokens):
        return model.decode_step(p, c, tokens)

    return Cell(cfg, shape, mesh, rules, model, decode_fn,
                (params, cache, inputs["tokens"]),
                (global_params, g_cache, g_inputs["tokens"]),
                (params_ps, cache_ps, in_ps["tokens"]), records, apart,
                unchecked)


def fsdp_train_step(model, hp: TrainHParams, compute):
    """The train step of one device that holds shards of its weights
    and optimizer state (ZeRO-3 over the data axes, and the router's
    experts axis): each shard is all-gathered to its compute shape (the
    leaves of ``compute``, meta tensors) before the forward pass, each
    gradient reduce-scattered back to its shard, and AdamW updates the
    shards -- ``train.make_train_step``'s pieces (``_value_and_grad``,
    ``apply_update``) around the gathers.  The collectives themselves
    are ``collective_records``'; here a gather or a scatter is an
    allocation of its result.  Counts only (``meta``)."""
    from repro_torch.models.param import tree_zip_map
    from repro_torch.train.train_step import _value_and_grad, apply_update

    if hp.microbatches != 1:
        raise NotImplementedError("a sharded cell counts one microbatch")

    def resize(t, like):
        if t.shape == like.shape:
            return t
        return torch.empty(like.shape, dtype=t.dtype, device=t.device)

    def step(state: TrainState, batch):
        full = tree_zip_map(resize, state.params, compute)
        (loss, metrics), grads = _value_and_grad(model, full, batch)
        del full
        grads = tree_zip_map(resize, grads, state.params)
        new, lr, gnorm = apply_update(state, grads, hp)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return new, out

    return step


# ----------------------------------------------------------------------
# The collectives the plan implies
# ----------------------------------------------------------------------
class Collective(tuple):
    """One collective of the plan: the tuple ``(kind, result bytes, group
    size)`` that ``launch/roofline.py`` costs, and ``shape``, the operand
    the reference's compiled program shows for it (an all-reduce's
    operand, an all-gather's or a reduce-scatter's result, one peer's
    piece of an all-to-all), or ``None`` where the plan keeps no shape
    (a parameter leaf's gather or scatter, the all-reduces of the rule
    without ``seq_sp``)."""

    def __new__(cls, kind: str, nbytes: int, group: int, shape=None):
        rec = super().__new__(cls, (kind, int(nbytes), group))
        rec.shape = None if shape is None else tuple(int(n) for n in shape)
        return rec

    def __getnewargs__(self):
        return (*self, self.shape)


def _ffn_width(cfg, kind: str) -> int:
    if cfg.moe is not None and kind.endswith("_dense"):
        return cfg.moe.d_ff_dense or cfg.d_ff
    return cfg.d_ff


# The layout changes of one layer's mixer under ``seq_sp`` (the
# reference's Megatron sequence parallelism: train and prefill split the
# sequence over the model axis between blocks), as the reference's
# compiled program issues them on a (2, 2) host mesh (module docstring).
# An entry is (kind, operand shape, forward, recompute, backward,
# prefill): how many the forward pass issues, the remat recompute, the
# backward pass and a prefill.  Shapes are built from the letters of
# ``_seq_sp_dims`` (digits stand for themselves).  An all-reduce reduces
# a product's partial sums, so under ``remat_policy="dots"`` (the
# products saved) its recompute count is dropped; every other kind is
# recomputed under either policy (``_DOTS`` gives the exceptions).
_AG, _AR, _A2A, _CP = ("all-gather", "all-reduce", "all-to-all",
                       "collective-permute")

_QK_NORM_Q = (            # the query's RMS norm on a sequence shard
    (_A2A, "B 1 sm hm dh", 0, 0, 2, 0), (_A2A, "B sm 1 hm 1", 0, 0, 1, 0),
    (_A2A, "B sm 1 hm dh", 0, 0, 2, 0))
_QK_NORM_K = (            # the key's, where the KV heads are split too
    (_A2A, "B 1 sm km dh", 0, 0, 2, 0), (_A2A, "B sm 1 km 1", 0, 0, 1, 0),
    (_A2A, "B sm 1 km dh", 0, 0, 2, 0))

_GQA = {
    # heads and KV heads split: q and k projected on the sequence shard
    # (their weights whole), rope's two halves of each resharded to
    # heads; v projected by heads on the gathered input; the output
    # projection's partial sums all-reduced; a prefill's cache resharded
    # to ``kv_seq`` (``_GQA_CACHE``)
    "split": (
        (_AG, "B S d", 1, 1, 1, 1), (_AR, "B S d", 1, 1, 3, 1),
        (_A2A, "B sm 1 hm dh2", 2, 2, 0, 2),
        (_A2A, "B sm 1 km dh2", 2, 2, 0, 2)),
    # one KV head, replicated: k and v gathered over the sequence, q on
    # the shard and resharded by rope's halves
    "one_kv": (
        (_AG, "B S K dh", 1, 1, 0, 1), (_AG, "B S Kdh", 1, 1, 0, 1),
        (_AG, "B S d", 0, 0, 2, 0), (_AR, "B S d", 1, 1, 1, 1),
        (_A2A, "B sm 1 hm dh2", 2, 2, 0, 2)),
    # several KV heads that divide the model axis without filling it (1 <
    # K < m): as one_kv but for the core's backward (``_GQA_CORE``; an
    # m = 4 program: no m = 2 one has such K)
    "kv_part": (
        (_AG, "B S K dh", 1, 1, 0, 1), (_AG, "B S Kdh", 1, 1, 0, 1),
        (_AG, "B S d", 0, 0, 2, 0), (_AR, "B S d", 1, 1, 1, 1),
        (_A2A, "B sm 1 hm dh2", 2, 2, 0, 2)),
    # several KV heads, replicated, the query no wider than the model:
    # as one_kv, but the attention's output resharded to the sequence
    # before the output projection (whole weight), not all-reduced
    "kv_on_seq": (
        (_AG, "B S d", 0, 0, 1, 0),
        (_AG, "B S K dh", 1, 1, 0, 1), (_AG, "B S Kdh", 1, 1, 0, 1),
        (_AR, "B S d", 0, 0, 1, 0),
        (_A2A, "B 1 sm hm dh", 1, 1, 0, 1),
        (_A2A, "B sm 1 hm dh2", 2, 2, 0, 2),
        (_A2A, "B sm 1 hm dh", 0, 0, 1, 0)),
    # several KV heads, replicated, the query wider than the model: the
    # input gathered and q projected by heads (no reshard of it, so no
    # norm's either), the output resharded to the sequence
    "x_gathered": (
        (_AG, "B S d", 1, 1, 1, 1),
        (_AG, "B S Kdh", 1, 1, 0, 1), (_AG, "B S K dh", 1, 1, 0, 1),
        (_AR, "B S d", 0, 0, 1, 0),
        (_A2A, "B 1 sm hmdh", 0, 0, 1, 0),
        (_A2A, "B 1 sm hm dh", 1, 1, 0, 1),
        (_A2A, "B sm 1 hm dh", 0, 0, 1, 0)),
}
# The attention core's backward pass (the scores' and the K/V
# gradients' layouts) where the sequence is one query chunk (S <=
# ``attn_chunk``).  Over several chunks (every train cell of the
# dry-run: 4,096 tokens in chunks of 1,024) the program lays it out
# otherwise, by the head counts (``unchecked_layout``), and the plan
# leaves it out.  kv_part's gathers run over the whole axis, the mK = m
# / K devices that share a KV head (a group's query heads) or the K
# that hold one each.
_GQA_CORE = {
    "split": (
        (_AG, "B S K dh", 0, 0, 1, 0),
        (_A2A, "B 1 km dh G sm", 0, 0, 1, 0),
        (_A2A, "B 1 km S sm G", 0, 0, 1, 0),
        (_A2A, "B hm 1 sm 1", 0, 0, 2, 0), (_A2A, "B hm 1 sm S", 0, 0, 1, 0)),
    "one_kv": (
        (_AR, "B K dh S", 0, 0, 1, 0), (_AR, "B K S dh", 0, 0, 1, 0),
        (_A2A, "B 1 sm K hm dh", 0, 0, 1, 0),
        (_A2A, "B 1 dh K hm sm", 0, 0, 1, 0),
        (_A2A, "B 1 S sm K hm", 0, 0, 1, 0),
        (_A2A, "B hm 1 sm 1", 0, 0, 2, 0), (_A2A, "B hm 1 sm S", 0, 0, 1, 0)),
    "kv_part": (
        (_AG, "B 1 G S S", 0, 0, 1, 0, "mK"), (_AG, "B K S S G", 0, 0, 2, 0),
        (_AG, "B K dh G S", 0, 0, 1, 0),
        (_AG, "B S 1 G dh", 0, 0, 1, 0, "mK"),
        (_AG, "B K dh S", 0, 0, 1, 0, "K"), (_AG, "B K S dh", 0, 0, 1, 0, "K"),
        (_A2A, "B hm 1 sm 1", 0, 0, 2, 0), (_A2A, "B hm 1 sm S", 0, 0, 1, 0)),
    "kv_on_seq": (
        (_AR, "B K dh S", 0, 0, 1, 0), (_AR, "B K S dh", 0, 0, 1, 0)),
    "x_gathered": (
        (_AR, "B K dh S", 0, 0, 1, 0), (_AR, "B K S dh", 0, 0, 1, 0)),
}
_GQA_CACHE = ((_A2A, "B 1 sm km dh", 0, 0, 0, 2),)

# MLA (heads split): the query's no-rope part and rope's halves of its
# rope part resharded to heads, the latent and the shared rope key
# gathered over the sequence, the output projection all-reduced
_MLA = (
    (_A2A, "B sm 1 hm dn", 1, 1, 0, 1), (_A2A, "B sm 1 hm dr2", 2, 2, 0, 2),
    (_AG, "B S dr", 1, 1, 0, 1), (_AG, "B S L", 1, 1, 0, 1),
    (_AR, "B S d", 1, 1, 0, 1),
    (_AG, "B S d", 0, 0, 1, 0), (_AG, "B S Q", 0, 0, 1, 0),
    (_AR, "B L S", 0, 0, 1, 0), (_AR, "B S dr", 0, 0, 1, 0),
    (_AR, "B S L", 0, 0, 1, 0), (_AR, "B S Q", 0, 0, 1, 0),
    (_A2A, "B 1 sm hm dr", 0, 0, 1, 0), (_A2A, "B 1 sm hm L", 0, 0, 1, 0),
    (_A2A, "B L 1 hm sm", 0, 0, 1, 0), (_A2A, "B S sm 1 hm", 0, 0, 2, 0),
    (_A2A, "B hm 1 sm 1", 0, 0, 2, 0), (_A2A, "B hm 1 sm S", 0, 0, 1, 0))

# The Mamba mixer (``d_inner`` split): the input gathered for
# ``in_proj``; ``x_proj``'s partial (dt, B, C) and ``out_proj``'s output
# all-reduced; the backward pass reshards the scan's tensors between the
# sequence and the channels.  Its collective-permutes depend on the
# model axis: ``_mamba_permutes``.
_MAMBA = (
    (_AG, "B S d", 1, 1, 1, 1), (_AG, "B S N", 0, 2, 1, 0),
    (_AG, "B S R", 0, 1, 0, 0), (_AG, "B S R2N", 0, 0, 1, 0),
    (_AR, "B S d", 1, 1, 1, 1), (_AR, "B S R2N", 1, 1, 0, 1),
    (_AR, "B S N", 0, 0, 1, 0), (_AR, "B S R", 0, 0, 1, 0),
    (_A2A, "B 1 sm Dm N", 0, 0, 1, 0), (_A2A, "B 1 sm Dm", 0, 0, 6, 0),
    (_A2A, "B sm 1 Dm N", 0, 0, 2, 0), (_A2A, "B sm 1 Dm", 0, 0, 3, 0),
    (_A2A, "B sm 1 Dm2", 0, 0, 1, 0),
    (_A2A, "B 1 sm Dm2", 0, 0, 0, 0))
# Where "dots" changes more than the all-reduces' recompute: the
# layout, then (kind, shape) -> its count a layer.  The Mamba mixer's
# backward reshards more (its all-to-all's 2D / m width read at m = 8:
# at m = 2 it is D).
_DOTS = {
    "mamba": {(_AG, "B S N"): 5, (_AG, "B S R"): 2,
              (_A2A, "B sm 1 Dm"): 6, (_A2A, "B 1 sm Dm2"): 1}}


def _mamba_permutes(m: int, dots: bool) -> tuple:
    """The Mamba mixer's collective-permutes at a model axis of m (a
    power of two), rows as ``_MAMBA``'s.

    The (x, z) split: ``in_proj``'s output lies in m column blocks of
    2D / m, x in the first m / 2 and z in the rest, and each half moves
    to D / m a device.  At m = 2 one half block goes each way.  At m >=
    4 x takes one permute of whole blocks (device 0's to device 1, j's
    to 2j) and one of half blocks (j's second half to 2j + 1), and z two
    of half blocks (to the even devices and to the odd ones).  The
    recompute repeats x's under either policy and z's under "nothing"
    only.

    The causal conv's backward pass runs on the sequence shards of its
    padded input (S + 3 rows, d_conv 4 as in every config of the repo),
    each ``ceil((S + 3) / m)`` rows: at m >= 4 one row longer than the
    sequence's shard, so device j's window is j rows off and the halos
    reach m - 1 rows: m - 1, m - 2, m - 3, m - 4 and 2 rows one way, m -
    4, 2 and 1 the other (an empty one dropped).  At m = 2 the padded
    shard is two rows longer: halos of 1, 1 and 2 rows one way, 1 the
    other.  Read from jamba's programs at m = 2, 4, 8 and 16, then held
    on one at m = 32 (8 x 1,024) predicted before it was compiled;
    ``unchecked_layout`` names the model axes and shards no program
    held."""
    if m == 2:
        return ((_CP, "B S Dm", 1, 1, 0, 1),
                (_CP, "B S Dm", 1, 0 if dots else 1, 0, 1),
                (_CP, "B 1 D", 0, 0, 3, 0), (_CP, "B 2 D", 0, 0, 1, 0))
    halos = [r for r in (m - 1, m - 2, m - 3, m - 4, 2, m - 4, 2, 1)
             if r > 0]
    return ((_CP, "B S Dm2", 1, 1, 0, 1), (_CP, "B S Dm", 1, 1, 0, 1),
            (_CP, "B S Dm", 2, 0 if dots else 2, 0, 2),
            *((_CP, f"B {r} D", 0, 0, 1, 0) for r in halos))
# the Mamba mixer's tensors the reference computes in float32 (dt, B, C
# and the scan's)
_MAMBA_F32 = {"B S N", "B S R", "B 1 sm Dm N", "B 1 sm Dm", "B sm 1 Dm N",
              "B sm 1 Dm", "B sm 1 Dm2", "B 1 sm Dm2"}


def _gqa_variant(cfg, m: int) -> str:
    """Which of ``_GQA``'s layouts the reference's program takes for a
    head-split attention layer, by how its K KV heads meet the model
    axis m: split with the heads (m divides K), one KV head, K dividing
    m, or K and m coprime, where the query's width a device (H / m x
    head dim) against the model's decides whether the query is
    resharded or the input gathered."""
    k = cfg.n_kv_heads
    if k % m == 0:
        return "split"
    if k == 1:
        return "one_kv"
    if m % k == 0:
        return "kv_part"
    if cfg.n_heads * cfg.head_dim // m <= cfg.d_model:
        return "kv_on_seq"
    return "x_gathered"


def unchecked_layout(cfg, shape, rules, model) -> str:
    """Why this cell's ``seq_sp`` plan (train and prefill) has no
    compiled program of the reference behind it, or "" where the
    collective-plan tests hold every layer's layout: the attention
    layouts were read from (2, 2) and (2, 4) programs of 64 tokens and
    held at (2, 8), which none was read from, and at the dry-run's own
    prefill cells (``tests/test_torch_collective_plan_real.py``); the
    Mamba permutes at model axes of 2 to 16 (``_mamba_permutes``).  The
    plan is still given where it is unchecked, the nearest layout's
    records less the chunked attention's backward: read such a cell's
    collective term as an estimate."""
    m = rules.axis_size("seq_sp")
    if m <= 1:
        return ""
    if cfg.family in ("rwkv", "encdec"):
        return (f"{cfg.family}: no seq_sp layout, the per-projection "
                f"all-reduces kept (ROADMAP C.5)")
    why = []
    kinds = {k.split("_")[0] for k in model._layer_kinds()}
    if kinds & {"attn", "mla"} and rules.axis_size("heads") <= 1:
        why.append("heads that do not divide the model axis")
    if "attn" in kinds and rules.axis_size("heads") > 1:
        k, v = cfg.n_kv_heads, _gqa_variant(cfg, m)
        if v in ("kv_on_seq", "x_gathered"):
            why.append(f"{k} KV heads that neither divide nor are divided "
                       f"by a model axis of {m}: the program takes "
                       f"kv_on_seq or x_gathered by more than the query's "
                       f"width (the batch and sequence too)")
        elif v in ("split", "kv_part") and \
                cfg.n_heads * cfg.head_dim // m > cfg.d_model:
            why.append("a query wider a device than the model with the "
                       "KV heads split or dividing the axis")
    if "attn" in kinds and rules.axis_size("heads") > 1 and \
            shape.kind == "train" and shape.seq_len > cfg.attn_chunk:
        why.append(f"the backward of attention over "
                   f"{shape.seq_len // cfg.attn_chunk} query chunks of "
                   f"{cfg.attn_chunk} (the program's layout varies with "
                   f"the head counts; the plan leaves it out)")
    if "mla" in kinds and rules.axis_size("heads") > 1 and \
            shape.seq_len > cfg.attn_chunk:
        why.append(f"MLA over {shape.seq_len // cfg.attn_chunk} query "
                   f"chunks of {cfg.attn_chunk} (the program gathers its "
                   f"latent and rope key by chunk)")
    if "mamba" in kinds and rules.axis_size("d_inner") > 1 and (
            m & (m - 1) or shape.seq_len // m < m
            or cfg.mamba.d_conv != 4):
        why.append(f"the Mamba mixer's collective-permutes at a model axis "
                   f"of {m} over shards of {shape.seq_len // m} rows: read "
                   f"at powers of two whose conv halos (up to m - 1 rows) "
                   f"fit in a shard")
    return "; ".join(why)


def _seq_sp_mixer(cfg, mix: str, dims: dict, train: bool, remat: bool,
                  dots: bool, kv_cache: bool, it: int, group: int) -> list:
    """The layout changes of one ``mix`` ("attn", "mla", "mamba") layer
    under ``seq_sp``: a list of ``Collective``."""
    layout = dims["variant"] if mix == "attn" else mix
    over = _DOTS.get(layout, {}) if train and remat and dots else {}
    if mix == "attn":
        table = _GQA[layout]
        if dims["S"] <= cfg.attn_chunk:
            table = table + _GQA_CORE[layout]
        if cfg.qk_norm and dims["variant"] != "x_gathered":
            table = table + _QK_NORM_Q
            if dims["variant"] == "split":
                table = table + _QK_NORM_K
        if kv_cache and dims["variant"] == "split":
            table = table + _GQA_CACHE
    elif mix == "mla":
        table = _MLA
    else:
        table = _MAMBA + _mamba_permutes(dims["m"], dots)
    out = []
    for kind, letters, fw, re, bw, pre, *among in table:
        if not train:
            n = pre
        elif not remat:
            n = fw + bw
        elif (kind, letters) in over:
            n = over[(kind, letters)]
        else:
            n = fw + bw + (0 if dots and kind == _AR else re)
        if not n:
            continue
        shape = tuple(dims[x] if x in dims else int(x)
                      for x in letters.split())
        size = math.prod(shape) * (4 if mix == "mamba"
                                   and letters in _MAMBA_F32 else it)
        g = dims[among[0]] if among else group
        if kind == _A2A:
            size *= g                      # one piece a peer
        out.extend([Collective(kind, size, g, shape)] * n)
    return out


def _seq_sp_dims(cfg, shape, rules, batch: int) -> dict:
    """The letters of the layout tables at this cell: B the device's
    batch, S the sequence, sm its shard, d the model width; hm and km
    the query and KV heads a device holds, K all KV heads, G the group,
    dh (dh2 = dh / 2) the head width; MLA's dn, dr (dr2), L and Q; the
    Mamba mixer's D, Dm, N, R (R2N = R + 2 N)."""
    m = rules.axis_size("seq_sp")
    s = shape.seq_len
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_split = rules.axis_size("kv_heads") > 1
    dims = dict(B=batch, S=s, sm=s // m, d=cfg.d_model, hm=h // m,
                km=k // m if kv_split else k, K=k, G=h // k, dh=dh,
                dh2=dh // 2, Kdh=k * dh, hmdh=h // m * dh, H=h, Hdh=h * dh,
                mK=max(m // k, 1), m=m,
                variant=_gqa_variant(cfg, m))
    if cfg.mla is not None:
        ml = cfg.mla
        dims.update(dn=ml.qk_nope_head_dim, dr=ml.qk_rope_head_dim,
                    dr2=ml.qk_rope_head_dim // 2, L=ml.kv_lora_rank,
                    Q=ml.q_lora_rank)
    if cfg.mamba is not None:
        from repro_torch.models.mamba import _dt_rank
        d_in = cfg.mamba.expand * cfg.d_model
        r, n = _dt_rank(cfg), cfg.mamba.d_state
        dims.update(D=d_in, Dm=d_in // m, Dm2=2 * d_in // m, N=n, R=r,
                    R2N=r + 2 * n)
    return dims


def collective_records(cfg, shape, rules, model, defs) -> list:
    """``Collective`` records of every collective one device takes part
    in, in one step of the plan.

    Where the rules map ``seq_sp`` to an axis (train and prefill; the
    reference's Megatron sequence parallelism: every block's input and
    output split over the sequence), a layer's activations follow the
    reference's compiled program (``_GQA``, ``_MLA``, ``_MAMBA``; the
    module docstring gives the evidence):

    * a head-split attention layer changes layout as its KV heads allow
      (``_gqa_variant``): split with the heads, q and k are projected on
      the sequence shard and rope's halves resharded to heads, v is
      projected by heads on the gathered input and the output
      projection's partial sums are all-reduced, 3 gathers, 5
      all-reduces and 23 all-to-alls a qwen3 layer under remat
      "nothing"; with one KV head, or K dividing the model axis m
      (``kv_part``: every assigned GQA arch at m = 16 but phi-3-vision),
      k and v are gathered over the sequence instead and the output
      all-reduced, and the backward pass all-reduces (one KV head) or
      gathers (``kv_part``, over m / K or K devices) the K/V gradients'
      pieces; with K and m coprime the output is resharded to the
      sequence (``kv_on_seq``) or the input gathered (``x_gathered``),
      a choice the program makes by more than the rule reads
      (``unchecked_layout``).  The attention core's backward pass
      (``_GQA_CORE``) is the program's where the sequence is one query
      chunk; over several (``attn_chunk``) the plan leaves it out;
    * MLA reshards the query's parts to heads and gathers the latent and
      the rope key;
    * a Mamba mixer gathers its input for ``in_proj``, moves the (x, z)
      halves of its output to the channels' layout by collective-
      permutes of whole and half column blocks, all-reduces
      ``x_proj``'s (dt, B, C) and ``out_proj``'s output, and in the
      backward pass reshards the scan's tensors and takes the causal
      conv's halos, which grow with the model axis
      (``_mamba_permutes``);
    * the FFN (dense, an MoE's shared expert) runs on the sequence shard
      with its weights whole, so it moves no activation;
    * the MoE ``shard_map`` takes and gives ``("batch", "seq_sp",
      "embed")`` blocks, so nothing enters or leaves it but the
      capacity buffers' two all-to-alls of E / e experts x
      capacity(the device's tokens) x d a peer, again in the recompute
      and the backward pass.

    Without ``seq_sp`` (decode), a layer all-reduces its activations
    after each row-parallel projection the table shards over the model
    axis: attention (``heads_flat``; MLA's too), the FFN (``d_ff``,
    where it divides the layer's width; the MoE shared expert's), the
    Mamba mixer (``d_inner``), RWKV's time-mix (``rwkv_heads``) and
    channel-mix (``d_ff``); the encoder's layers over the frames, the
    decoder's cross-attention.  RWKV and the encoder-decoder keep that
    rule in training and prefill too (ROADMAP §C.5).  With a
    vocab-parallel embedding one all-reduce more after the embedding.

    Per parameter leaf the program uses whole but a device holds a
    shard of (``fsdp`` over the data axes, the router), an all-gather of
    it; in training a reduce-scatter of its gradient, and the gather
    again in the backward pass under remat.

    Remat.  Under "nothing" the recompute repeats the forward pass's
    layout changes.  Under "dots" (the products' outputs saved) it
    repeats none of the all-reduces, each of which reduces a product's
    partial sums, and the rest as under "nothing" (the Mamba mixer's
    backward differs, ``_DOTS``, and its z half is not moved again).
    Without ``seq_sp``, the
    recompute repeats every activation all-reduce of its remat unit (a
    layer; a hybrid's superblock, or each sublayer under
    ``sublayer_remat``) but the unit's last, which only adds into the
    unit's saved output; "dots" repeats none (the encdec has no such
    policy).  The all-to-alls (their outputs feed batched products,
    which are recomputed) and the all-gathers run again under either
    policy.  The reference's compiled program shows the rule without
    ``seq_sp``' all-reduces on granite-3-2b: 5 a layer under "nothing",
    4 under "dots" and 4 without remat
    (``tests/test_torch_hillclimb.py::
    test_the_dots_rule_is_the_reference_s_compiled_program``).
    """
    if rules.mesh is None:
        return []
    out = []
    it = DTYPES[cfg.dtype].itemsize
    train = shape.kind == "train"
    passes = (3 if cfg.remat else 2) if train else 1
    dots = cfg.remat_policy == "dots" and cfg.family != "encdec"
    batch = local_shape((shape.global_batch,), ("batch",), rules)[0]
    tokens = batch * (1 if shape.kind == "decode" else shape.seq_len)
    act = tokens * cfg.d_model * it
    m_sp = rules.axis_size("seq_sp")
    seq_sp = m_sp > 1 and cfg.family not in ("rwkv", "encdec")

    def reduce(on: bool, nbytes: int, group: int, n: int = 1,
               last: bool = False):
        if on and group > 1:
            k = passes - (train and cfg.remat and (dots or last))
            out.extend([Collective("all-reduce", nbytes, group)] * (n * k))

    tp = {n: rules.axis_size(n) for n in ("heads_flat", "d_ff", "d_inner",
                                          "rwkv_heads", "vocab",
                                          "experts", "heads")}
    reduce(True, act, tp["vocab"])
    if cfg.family == "encdec":
        n_dec = cfg.n_layers
        f_ok = cfg.d_ff % tp["d_ff"] == 0
        if shape.kind != "decode":
            enc = batch * cfg.encdec.enc_len * cfg.d_model * it
            reduce(True, enc, tp["heads_flat"], cfg.encdec.enc_layers)
            reduce(f_ok, enc, tp["d_ff"], cfg.encdec.enc_layers, last=True)
        reduce(True, act, tp["heads_flat"], 2 * n_dec)
        reduce(f_ok, act, tp["d_ff"], n_dec, last=True)
        return out + _param_records(cfg, train, rules, defs)
    dims = _seq_sp_dims(cfg, shape, rules, batch) if seq_sp else None
    kv_cache = shape.kind == "prefill" and rules.axis_size("kv_seq") > 1
    kinds = model._layer_kinds()
    unit = (cfg.hybrid.attn_period
            if cfg.hybrid is not None and not cfg.sublayer_remat else 1)
    for i, kind in enumerate(kinds):
        # the FFN's all-reduce ends the layer; it ends the remat unit
        # where the layer does
        last = (i + 1) % unit == 0 or i + 1 == len(kinds)
        if kind == "rwkv":
            reduce(True, act, tp["rwkv_heads"])
            reduce(cfg.d_ff % tp["d_ff"] == 0, act, tp["d_ff"],
                   last=last)
            continue
        mix, ff = kind.split("_")
        split = tp["d_inner" if mix == "mamba" else "heads"] > 1
        if seq_sp and split:
            out.extend(_seq_sp_mixer(cfg, mix, dims, train, cfg.remat,
                                     dots, kv_cache, it, m_sp))
        elif not seq_sp:
            reduce(True, act, tp["d_inner"] if mix == "mamba"
                   else tp["heads_flat"])
        # under seq_sp a mixer the table leaves whole gets no record: no
        # program of the reference was read for one
        if ff == "dense":
            if not seq_sp:
                width = _ffn_width(cfg, kind)
                reduce(width % tp["d_ff"] == 0, act, tp["d_ff"], last=last)
            continue
        mo = cfg.moe
        if mo.n_shared and not seq_sp:
            width = mo.d_expert * mo.n_shared
            reduce(width % tp["d_ff"] == 0, act, tp["d_ff"], last=last)
        if tp["experts"] > 1:
            from repro_torch.models.layers import _capacity
            e = tp["experts"]
            local_e = math.ceil(mo.n_experts / e)
            if seq_sp:
                # the map's tokens: the device's batch share of its
                # sequence shard; one (E / e, capacity, d) piece a peer
                cap = _capacity(batch * (shape.seq_len // m_sp), mo)
                piece = (local_e, cap, cfg.d_model)
                out.extend([Collective("all-to-all",
                                       math.prod(piece) * it * e, e,
                                       piece)] * (2 * passes))
            else:
                rows = local_e * _capacity(tokens, mo)
                out.extend([Collective("all-to-all",
                                       rows * cfg.d_model * it, e)]
                           * (2 * passes))
    return out + _param_records(cfg, train, rules, defs)


def _param_records(cfg, train: bool, rules, defs) -> list:
    """Per parameter leaf the program uses whole but a device holds a
    shard of: an all-gather of it (again in the backward pass under
    remat) and, in training, a reduce-scatter of its gradient."""
    out = []

    def gathers(path, d):
        full = math.prod(local_shape(d.shape, compute_names(path, d.names),
                                     rules)) * DTYPES[d.dtype].itemsize
        held = shard_bytes(d.shape, DTYPES[d.dtype].itemsize,
                           pspec_for(d.shape, d.names, rules), rules.mesh)
        if full > held:
            g = full // held
            out.extend([Collective("all-gather", full, g)]
                       * ((2 if cfg.remat else 1) if train else 1))
            if train:
                out.append(Collective("reduce-scatter", held, g))

    _walk_defs(defs, gathers)
    return out


def count_cell(cell: Cell):
    """Run ``cell`` under ``launch.opcount.OpCount`` (its arguments
    live from the start) and add its work counted apart
    (``Cell.apart``); returns (counter, output)."""
    from repro_torch.launch.opcount import OpCount
    with OpCount(args=cell.args) as oc:
        out = cell.run()
    for name, flops, nbytes in cell.apart:
        oc.add(name, flops, nbytes)
    return oc, out
