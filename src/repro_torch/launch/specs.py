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
* the sequence is not split (``seq_sp``, ``kv_seq``): a device runs its
  batch share's whole sequence, and a decode cell reads the KV rows of
  its own heads over the whole cache, where the reference reads all
  heads over its sequence shard.  Their FLOPs agree; their cache bytes
  agree unless the KV heads are replicated (then a device here reads
  those its query heads use).

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
    (name, flops, bytes), which ``count_cell`` adds."""

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
                    (state_ps, in_ps), records, apart)

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
                    (params_ps, in_ps), records, apart)

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
                (params_ps, cache_ps, in_ps["tokens"]), records, apart)


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
def _ffn_width(cfg, kind: str) -> int:
    if cfg.moe is not None and kind.endswith("_dense"):
        return cfg.moe.d_ff_dense or cfg.d_ff
    return cfg.d_ff


def collective_records(cfg, shape, rules, model, defs) -> list:
    """(kind, result bytes, group size) of every collective one device
    takes part in, in one step of the plan:

    * per layer, an all-reduce of the local activations after each
      row-parallel projection the table shards over the model axis:
      attention (``heads_flat``; MLA's too), the FFN (``d_ff``, where it
      divides the layer's width; the MoE shared expert's), the Mamba
      mixer (``d_inner``), RWKV's time-mix (``rwkv_heads``) and
      channel-mix (``d_ff``); the encoder's layers over the frames, the
      decoder's cross-attention; with a vocab-parallel embedding one more
      after the embedding;
    * per MoE layer whose experts are sharded, two all-to-alls (dispatch
      and combine) of the device's capacity rows;
    * per parameter leaf the program uses whole but a device holds a
      shard of (``fsdp`` over the data axes, the router), an all-gather
      of it;
    * in training: every activation collective in the forward pass, the
      backward pass and, under remat, the recomputed forward; the
      all-gathers again in the backward pass under remat; and a
      reduce-scatter of each such leaf's gradient.

    Under remat the recomputed forward repeats every activation
    all-reduce of its remat unit (a layer; a hybrid's superblock, or
    each sublayer under ``sublayer_remat``) but the unit's last: that
    one only adds into the unit's output, which is saved as the next
    unit's input, so the backward pass needs it from no recomputation.
    ``remat_policy="dots"`` (the products' outputs saved; the encdec
    has no such policy) repeats none: each all-reduce reduces a saved
    product's output, which the recomputed forward takes as it was.
    The all-to-alls (their outputs feed batched products, which are
    recomputed) and the all-gathers (a gathered weight is a product's
    input, not its output) run again under either policy.  The
    reference's compiled program shows the all-reduce rule: granite-3-2b
    on a (2, 4) host mesh at train_4k, 2 and 3 layers, counts per layer
    5 activation all-reduces under "nothing", 4 under "dots" and 4
    without remat, and all-gathers of 3.389e9, 3.380e9 and 2.235e9
    elements (``tests/test_torch_hillclimb.py::
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

    def reduce(on: bool, nbytes: int, group: int, n: int = 1,
               last: bool = False):
        if on and group > 1:
            k = passes - (train and cfg.remat and (dots or last))
            out.extend([("all-reduce", nbytes, group)] * (n * k))

    tp = {n: rules.axis_size(n) for n in ("heads_flat", "d_ff", "d_inner",
                                          "rwkv_heads", "vocab",
                                          "experts")}
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
    else:
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
            reduce(True, act, tp["d_inner"] if mix == "mamba"
                   else tp["heads_flat"])
            if ff == "dense":
                width = _ffn_width(cfg, kind)
                reduce(width % tp["d_ff"] == 0, act, tp["d_ff"], last=last)
                continue
            mo = cfg.moe
            if mo.n_shared:
                width = mo.d_expert * mo.n_shared
                reduce(width % tp["d_ff"] == 0, act, tp["d_ff"], last=last)
            if tp["experts"] > 1:
                from repro_torch.models.layers import _capacity
                local_e = math.ceil(mo.n_experts / tp["experts"])
                rows = local_e * _capacity(tokens, mo)
                out.extend([("all-to-all", rows * cfg.d_model * it,
                             tp["experts"])] * (2 * passes))

    def gathers(path, d):
        full = math.prod(local_shape(d.shape, compute_names(path, d.names),
                                     rules)) * DTYPES[d.dtype].itemsize
        held = shard_bytes(d.shape, DTYPES[d.dtype].itemsize,
                           pspec_for(d.shape, d.names, rules), rules.mesh)
        if full > held:
            g = full // held
            out.extend([("all-gather", full, g)]
                       * ((2 if cfg.remat else 1) if train else 1))
            if train:
                out.append(("reduce-scatter", held, g))

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
