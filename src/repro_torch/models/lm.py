"""Decoder-only language model: the dense, moe, mla_moe, hybrid, rwkv
and vlm families (PyTorch port).

The counterpart of the reference ``models/lm.py::LM`` for
``family == "dense"`` (``attn_dense`` blocks), ``"vlm"`` (a dense
backbone behind a ``patch_proj`` prefix: ``prefill`` takes optional
float32 ``patch_embeds`` (B, P, E) beside the tokens, projects them and
puts them before the token embeddings), ``"moe"`` (``attn_moe``:
GQA and a top-k MoE FFN), ``"mla_moe"`` (DeepSeek-V3: ``first_k_dense``
``mla_dense`` blocks, then ``mla_moe`` blocks with a sigmoid router and
a shared expert), ``"hybrid"`` (jamba: superblocks of ``attn_period``
sublayers, GQA at ``attn_offset`` and a Mamba mixer at the others, a
softmax-routed MoE FFN every ``moe_every`` layers and a dense one
between) and ``"rwkv"`` (RWKV-6 blocks): the same parameter tree (one
``"blocks"`` stack with a leading layer axis, or mla_moe's
``"dense_blocks"`` and ``"moe_blocks"`` stacks and its ``"mtp"``
subtree, which serving leaves unused, or hybrid's ``"superblocks"``:
one stack per sublayer ``l{j}_{kind}`` with a leading superblock axis),
the same cache tree, and the same ``prefill`` / ``decode_step`` API.
Layers run as one Python loop over each stack's repeats and their
sublayers.  Caches are updated in place where the reference's jitted
callers donate them.  An rwkv cache holds each layer's recurrent state
(``S`` and the two token-shift rows) instead of K/V rows, an MLA cache
the latent ``c_kv`` and ``k_rope`` rows, a Mamba sublayer's cache its
state ``h`` and conv rows.

  lm = LM(cfg, device="cuda")
  params = lm.init(seed=0)                 # or param.from_jax(tree)
  logits, cache = lm.prefill(params, {"tokens": toks}, max_len=2048)
  logits, cache = lm.decode_step(params, cache, next_tokens)

``train_loss`` is the reference's ``mode == "train"`` path: every
block on the plain PyTorch versions whatever ``kernels`` says (the
kernels have no backward; the reference's train mode runs jnp under
autodiff, with no Pallas kernel), the MoE layers' load-balance ``aux``
averaged as the reference averages it, remat by ``cfg.remat``,
``remat_policy`` and ``sublayer_remat`` through
``torch.utils.checkpoint``, the attention options ``causal_skip`` and
``attn_bf16_scores`` on the plain path, cross entropy
over the padded vocabulary, and DeepSeek's MTP loss.

  loss, metrics = lm.train_loss(params, {"tokens": t, "labels": y})

``LM(cfg, grid=grid)`` trains sharded on a ``parallel.grid.Grid`` (the
reference's ``make_rules(cfg, mesh, "train")`` layout: FSDP over the
data axis; over the model axis, every family's Megatron layers (GQA
and MLA attention by heads, the Mamba mixer by channels, RWKV-6's
time-mix by heads and channel-mix by ``d_ff``, the FFNs by ``d_ff``;
a dimension the rules leave whole is replicated), vocab-parallel
embedding, head and cross entropy and the expert-parallel MoE of
``_moe_shard_map``; DeepSeek's MTP block and a VLM's patch rows take
the same layout); ``train_loss`` then takes the global batch and this
rank's parameter blocks (``lm.shard(full)``).  ``GridTraining`` holds
the parts ``models.encdec.EncDecLM`` shares.

``verify_step`` scores a T-token window per slot (speculative
decoding).  With a ``tp_group`` (tensor parallelism, one process per
shard: ``repro_torch.serving.sharded``) the LM is one shard of the
Megatron layout, built from ``parallel.tp_local_config``: it
all-reduces each block's attention output and FFN output over the
group, where the reference calls ``tp_psum``.  The paged engine's cache tree (``init_paged_cache``) holds
page pools shared by all slots plus a ``pages`` table; ``decode_step``
and ``verify_step`` then go through the page table.  Both need
random-access KV attention and raise ``NotImplementedError`` for rwkv,
MLA and hybrid, as the reference does; the paged cache, as the
reference's, takes the dense and moe families only.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models.param import (DTYPES, ParamDef, init_params,
                                      stack_tree, tree_map)
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import split_axes

_FAMILIES = ("dense", "moe", "mla_moe", "hybrid", "rwkv", "vlm")

AUX_COEF = 0.01
MTP_COEF = 0.3


def token_ce(logits_f32, labels, vocab: int, vocab_padded: int):
    """Each position's cross entropy over the padded vocabulary: the
    padded columns set to ``MASK_VALUE``, logsumexp minus the target's
    logit.  logits: (..., Vp) float32; labels: (...) int -> (...)."""
    if vocab_padded > vocab:
        pad = torch.arange(vocab_padded, device=logits_f32.device) >= vocab
        logits_f32 = logits_f32.masked_fill(pad, L.MASK_VALUE)
    lse = torch.logsumexp(logits_f32, dim=-1)
    tgt = torch.gather(logits_f32, -1, labels.long()[..., None])[..., 0]
    return lse - tgt


def _ce_loss(logits_f32, labels, vocab: int, vocab_padded: int,
             weights=None):
    """Cross entropy (reference ``_ce_loss``): ``token_ce``'s mean, or
    sum(ce * w) / max(sum w, 1) under ``weights``."""
    ce = token_ce(logits_f32, labels, vocab, vocab_padded)
    if weights is None:
        return ce.mean()
    w = weights.to(ce.dtype)
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def check_model_axis(cfg: ModelConfig, model: int) -> None:
    """Raise ``NotImplementedError`` where the port cannot follow the
    reference's train layout at model axis ``model``: an MoE config
    whose experts do not divide it (the reference then runs its
    one-device MoE layer under GSPMD, expert capacity over the global
    batch, which no rank of the port sees).  Every other dimension the
    rules leave whole is replicated, as the reference replicates it."""
    if model > 1 and cfg.moe is not None and cfg.moe.n_experts % model:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.moe.n_experts} experts over a model axis of "
            f"{model}: the reference's replicated MoE layer routes the "
            f"global batch, which the port's ranks do not see (ROADMAP "
            f"§A.8)")


def model_split(specs, *path) -> bool:
    """Whether the leaf at ``path`` of a block's partition ``specs`` is
    split over the model axis: its layer then runs tensor-parallel
    (every layer on a size-1 axis too); a leaf the rules leave whole
    runs the plain layer, replicated.  False off a grid."""
    if specs is None:
        return False
    for key in path:
        specs = specs[key]
    return "model" in split_axes(specs)


class GridTraining:
    """Sharded training's parts that do not depend on the layers, for
    ``LM`` and ``models.encdec.EncDecLM`` on a ``parallel.grid.Grid``:
    the train-mode layout (``rules``, ``pspecs``), ``shard`` and
    ``gather``, the FSDP gather of a top-level leaf, the vocab-parallel
    embedding, head and cross entropy, and the rank's share of the loss.
    The host class has ``cfg``, ``vp``, ``grid`` and ``param_defs``."""

    def _init_grid(self, grid) -> None:
        """The train-mode layout on ``grid``: the reference's rules and
        each parameter's partition spec (``check_model_axis`` says what
        stays refused)."""
        from repro_torch.parallel.sharding import param_pspecs
        check_model_axis(self.cfg, grid.model)
        self.rules = grid.rules(self.cfg)
        self.pspecs = param_pspecs(self.param_defs(), self.rules)
        self.vocab_split = "model" in split_axes(self.pspecs["embed"])

    def shard(self, params):
        """This rank's blocks of full ``params`` under the grid's
        layout (``parallel.sharding.shard_tree``)."""
        from repro_torch.parallel.sharding import shard_tree
        return shard_tree(params, self.pspecs, self.grid.mesh,
                          self.grid.axis_coords)

    def gather(self, params):
        """Full parameters from every rank's blocks (no gradient)."""
        from repro_torch.parallel.sharding import gather_tree
        return gather_tree(params, self.pspecs, self.grid)

    def _block_specs(self, name):
        """The partition specs of one repeat of stack ``name`` (the
        stacked layer axis dropped), ``None`` off a grid."""
        if self.grid is None:
            return None
        return tree_map(lambda sp: tuple(sp[1:]), self.pspecs[name])

    def _ffn(self, x, p, split: bool):
        """A SwiGLU FFN, tensor-parallel over the grid's model group
        where ``split`` (``ffn_tp``), else whole."""
        if split:
            return L.ffn_tp(x, p, self.grid.model_group)
        return L.ffn(x, p)

    def _fsdp(self, params, name):
        """Top-level leaf ``name``, its FSDP dims gathered on a grid."""
        if self.grid is None:
            return params[name]
        from repro_torch.parallel.sharding import gather_fsdp
        return gather_fsdp(params[name], self.pspecs[name], self.grid)

    def _embed_rows(self, params, tokens):
        """The embedding rows of ``tokens``.  On a grid the table is
        vocab-parallel: each rank looks up the tokens in its block of
        rows (the others masked to 0) and the model group all-reduces."""
        if self.grid is None:
            return params["embed"][tokens]
        w = self._fsdp(params, "embed")
        if not self.vocab_split:
            return w[tokens]
        vl = w.shape[0]
        idx = tokens.long() - self.grid.index("model") * vl
        own = ((idx >= 0) & (idx < vl))[..., None]
        rows = torch.where(own, w[idx.clamp(0, vl - 1)], 0.0)
        return C.reduce_from(rows, self.grid.model_group)

    def _logits(self, params, x):
        """float32 logits; on a grid the rank's vocabulary block (the
        head column-split over the model group)."""
        x = L.rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        if self.grid is None:
            return (x @ params["lm_head"]).float()
        if self.vocab_split:
            x = C.copy_to(x, self.grid.model_group)
        return (x @ self._fsdp(params, "lm_head")).float()

    def _ce_grid(self, logits, labels, weights, denom):
        """The rank's share of the vocab-parallel cross entropy: logits
        (B, S, Vp / model) this rank's vocabulary block.  The padded
        columns are masked; the row max (no gradient) is all-reduced
        with MAX over the model group, the sum of exponentials and the
        label's logit (taken on the rank that owns it, 0 elsewhere)
        with SUM; then sum(ce [x weights]) / ``denom``."""
        grid = self.grid
        if not self.vocab_split:
            ce = token_ce(logits, labels, self.cfg.vocab_size, self.vp)
        else:
            vl = logits.shape[-1]
            lo = grid.index("model") * vl
            col = lo + torch.arange(vl, device=logits.device)
            logits = logits.masked_fill(col >= self.cfg.vocab_size,
                                        L.MASK_VALUE)
            mx = C.all_reduce_max(logits.detach().amax(-1), grid.model_group)
            idx = labels.long() - lo
            own = (idx >= 0) & (idx < vl)
            tgt = torch.gather(logits, -1, idx.clamp(0, vl - 1)[..., None])[
                ..., 0]
            se, tgt = C.reduce_from(torch.stack([
                torch.exp(logits - mx[..., None]).sum(-1),
                torch.where(own, tgt, 0.0)]), grid.model_group).unbind()
            ce = mx + torch.log(se) - tgt
        if weights is not None:
            ce = ce * weights.to(ce.dtype)
        return ce.sum() / denom

    def _rank_rows(self, batch):
        """(the rank's rows of the global ``batch``: those of its data
        index, as the reference shards the batch over data; the global
        cross entropy's denominator: the token count, or the
        ``loss_mask`` weight, at least 1)."""
        grid = self.grid
        rows = next(iter(batch.values())).shape[0]
        if rows % grid.data:
            raise ValueError(f"batch of {rows} rows does not split over "
                             f"the data axis ({grid.data})")
        step = rows // grid.data
        lo = grid.index("data") * step
        labels, w = batch["labels"], batch.get("loss_mask")
        denom = (labels.numel() if w is None else
                 torch.clamp(w.float().sum(), min=1.0))
        return {k: v[lo:lo + step] for k, v in batch.items()}, denom

    def _grid_loss(self, terms: dict, coefs: dict):
        """(loss, metrics) from the rank's ``terms``, each its share of
        the global one (they sum over the data group to the reference's
        value): the returned loss carries the global value (the shares
        all-reduced over data, no gradient) and the gradient of the
        rank's share, sum(coefs[k] x terms[k]); metrics are the global
        values of every term."""
        share = sum(c * terms[k] for k, c in coefs.items())
        vals = C.all_reduce_sum(torch.stack(
            [t.detach().float() for t in terms.values()]),
            self.grid.data_group)
        metrics = dict(zip(terms, vals.unbind()))
        total = sum(c * metrics[k] for k, c in coefs.items())
        return share + (total - share.detach()), metrics


class LM(GridTraining):
    """Dense or MoE GQA decoder, MLA-MoE decoder, Mamba + GQA hybrid,
    RWKV-6 stack or VLM backbone.
    ``device`` defaults to ``cuda`` and raises when no GPU is visible.
    ``kernels=False`` sends attention and the scan to the plain PyTorch
    versions on any device (the on-card yardstick); with ``kernels=True``
    CUDA tensors go through the hand-written kernels and CPU tensors
    through the same plain versions (MLA, Mamba and the MoE layer have
    no kernel: both settings run them alike).  ``tp_group``: the process
    group of a tensor-parallel shard (``None``: the whole model, no
    collective); the group belongs to the model, so a speculative draft
    built without one stays replicated in the same thread.  ``grid``:
    sharded training on a ``parallel.grid.Grid`` (``train_loss`` only;
    see ``_train_loss_grid``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kernels: bool = True, tp_group=None, grid=None):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} has no decoder-only LM (encdec and "
                f"tiny have their own models)")
        self.cfg = cfg
        self.vp = L.pad_vocab(cfg.vocab_size)
        self.device = resolve_device(device)
        self.kernels = kernels
        self.dtype = DTYPES[cfg.dtype]
        # (stack name, its sublayers as (key, kind), repeats) in the
        # order they run; key None: the stack's leaves are the block's
        if cfg.family == "hybrid":
            period = cfg.hybrid.attn_period
            self.groups = [("superblocks",
                            [(f"l{j}_{kind}", kind) for j, kind in
                             enumerate(self._layer_kinds()[:period])],
                            cfg.n_layers // period)]
        elif cfg.family == "mla_moe":
            k = cfg.moe.first_k_dense
            self.groups = [("dense_blocks", [(None, "mla_dense")], k),
                           ("moe_blocks", [(None, "mla_moe")],
                            cfg.n_layers - k)]
        else:       # a homogeneous stack of the first layer's kind
            self.groups = [("blocks", [(None, self._layer_kinds()[0])],
                            cfg.n_layers)]
        self.tp_group = tp_group
        if tp_group is not None and cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: serving tensor parallelism shards "
                f"dense GQA stacks only, as the reference's "
                f"tp_local_config (ROADMAP §A.8)")
        self.grid = grid
        if grid is not None:
            if tp_group is not None:
                raise ValueError("a serving tp_group and a training grid")
            self._init_grid(grid)

    def _layer_kinds(self) -> list[str]:
        """Each layer's kind, as the reference's ``LM._layer_kinds``."""
        cfg = self.cfg
        kinds = []
        for i in range(cfg.n_layers):
            if cfg.family == "rwkv":
                kinds.append("rwkv")
                continue
            is_attn = (cfg.hybrid is None or i % cfg.hybrid.attn_period
                       == cfg.hybrid.attn_offset)
            mix = ("mla" if cfg.mla is not None else
                   ("attn" if is_attn else "mamba"))
            is_moe = False
            if cfg.moe is not None:
                is_moe = (i >= cfg.moe.first_k_dense
                          and (i % cfg.moe.moe_every) == 0)
            kinds.append(f"{mix}_{'moe' if is_moe else 'dense'}")
        return kinds

    def check_verify(self) -> None:
        """Raise ``NotImplementedError`` unless every layer has
        random-access KV attention (an ``attn_*`` kind): verify windows
        and paged KV need it; an rwkv or Mamba state and an MLA latent
        cache have neither (the reference raises the same)."""
        for _, subs, _ in self.groups:
            for _, kind in subs:
                if not kind.startswith("attn_"):
                    raise NotImplementedError(
                        f"speculative verify and paged KV need random-access "
                        f"KV attention; family {self.cfg.family!r} (layer "
                        f"kind {kind!r}) has no multi-token verify or "
                        f"page-table path")

    @staticmethod
    def _sublayers(subs, fn):
        """One repeat of a stack: ``fn(kind)`` of its one block, or a
        dict of them by sublayer key."""
        if subs[0][0] is None:
            return fn(subs[0][1])
        return {key: fn(kind) for key, kind in subs}

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def _block_defs(self, kind: str) -> dict:
        """One block of layer kind ``kind``."""
        cfg = self.cfg
        d = {"ln1": L.rmsnorm_def(cfg.d_model, cfg.dtype),
             "ln2": L.rmsnorm_def(cfg.d_model, cfg.dtype)}
        if kind == "rwkv":
            d["time"] = R.rwkv_time_defs(cfg)
            d["chan"] = R.rwkv_channel_defs(cfg)
            return d
        mix, ff = kind.split("_")
        if mix == "mamba":
            d["mamba"] = M.mamba_defs(cfg)
        else:
            d["attn"] = L.gqa_defs(cfg) if mix == "attn" else L.mla_defs(cfg)
        if ff == "moe":
            d["moe"] = L.moe_defs(cfg)
        else:
            d["ffn"] = L.ffn_defs(cfg, cfg.moe.d_ff_dense if cfg.moe
                                  else None)
        return d

    def param_defs(self):
        cfg = self.cfg
        dt = cfg.dtype
        defs: dict[str, Any] = {
            "embed": ParamDef((self.vp, cfg.d_model), ("vocab", "fsdp"),
                              "embed", dt),
            "final_norm": L.rmsnorm_def(cfg.d_model, dt),
            # randomly initialised over the padded columns too, as in the
            # reference: greedy argmax runs over all of them
            "lm_head": ParamDef((cfg.d_model, self.vp), ("fsdp", "vocab"),
                                "normal", dt),
        }
        for name, subs, n in self.groups:
            defs[name] = stack_tree(self._sublayers(subs, self._block_defs),
                                    n)
        if cfg.vlm is not None:
            pe = cfg.vlm.patch_embed_dim or cfg.d_model
            defs["patch_proj"] = ParamDef((pe, cfg.d_model), (None, "fsdp"),
                                          "normal", dt)
        if cfg.mtp:         # DeepSeek-V3's training-only MTP module
            defs["mtp"] = {
                "proj": ParamDef((2 * cfg.d_model, cfg.d_model),
                                 ("fsdp", "embed"), "normal", dt),
                "norm_h": L.rmsnorm_def(cfg.d_model, dt),
                "norm_e": L.rmsnorm_def(cfg.d_model, dt),
                "block": self._block_defs(
                    "mla_dense" if cfg.mla is not None else "attn_dense"),
            }
        return defs

    def init(self, seed: int = 0):
        """Seeded random weights, drawn on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen)

    # ------------------------------------------------------------------
    # Block application
    # ------------------------------------------------------------------
    def _apply_block(self, x, bp, kind, mode, cache, pos, pages=None,
                     dest=None):
        """One block of layer kind ``kind``; ``cache`` (this layer's dict
        of cache leaves) is written in place.  An ``attn_*`` block's
        cache is dict(k, v); ``pages`` (B, NB) switches its decode and
        verify to the paged KV pool: the cache leaves are then shared
        physical pages, not per-slot rows (``dest``: the window's
        ``paged_dest``).  An ``mla_*`` block's cache is dict(c_kv,
        k_rope), a ``mamba_*`` block's dict(h, conv).  A ``*_moe`` block
        routes all of the call's tokens through one capacity-limited MoE
        layer.  Returns the block output."""
        cfg = self.cfg
        if kind == "rwkv":
            return self._apply_rwkv_block(x, bp, mode, cache)
        mix, ff = kind.split("_")
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        if mode not in ("prefill", "decode", "verify"):
            raise NotImplementedError(
                f"mode {mode!r}: serving modes are prefill, decode and "
                f"verify; training runs through train_loss")
        if mix == "mla":
            o = self._mla(h, bp["attn"], mode, cache, pos)
        elif mix == "mamba":
            o = self._mamba(h, bp["mamba"], mode, cache)
        elif mode == "prefill":
            o, (k, v) = L.gqa_prefill(h, bp["attn"], cfg,
                                      kernels=self.kernels)
            s = k.shape[1]
            # the reference pads K/V to the cache length with zeros
            cache["k"][:, :s] = k
            cache["k"][:, s:] = 0
            cache["v"][:, :s] = v
            cache["v"][:, s:] = 0
        elif mode == "decode" and pages is not None:
            o = L.gqa_decode_paged(h, bp["attn"], cfg, cache, pos, pages,
                                   kernels=self.kernels, dest=dest)
        elif mode == "decode":
            o = L.gqa_decode(h, bp["attn"], cfg, cache, pos,
                             kernels=self.kernels)
        elif pages is not None:
            o = L.gqa_verify_paged(h, bp["attn"], cfg, cache, pos, pages,
                                   kernels=self.kernels, dest=dest)
        else:
            o = L.gqa_verify(h, bp["attn"], cfg, cache, pos,
                             kernels=self.kernels)
        x = x + self._reduce(o)
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if ff == "moe":
            router = "sigmoid" if cfg.family == "mla_moe" else "softmax"
            moe = L.moe_decode if mode == "decode" else L.moe_ffn
            return x + moe(h2, bp["moe"], cfg, router)[0]
        return x + self._reduce(L.ffn(h2, bp["ffn"]))

    def _mla(self, h, p, mode, cache, pos):
        """An MLA block's attention (plain PyTorch: the reference's is
        jnp, with no Pallas kernel).  Prefill writes the latent rows at
        [0, S) and zeros after, as the reference pads them."""
        if mode == "decode":
            return L.mla_decode(h, p, self.cfg, cache, pos)
        if mode != "prefill":
            raise NotImplementedError(
                f"mode {mode!r}: an MLA block has prefill and decode only "
                f"(no multi-token verify path, as in the reference)")
        o, (c_kv, k_rope) = L.mla_prefill(h, p, self.cfg)
        s = c_kv.shape[1]
        for name, new in (("c_kv", c_kv), ("k_rope", k_rope)):
            cache[name][:, :s] = new
            cache[name][:, s:] = 0
        return o

    def _mamba(self, h, p, mode, cache):
        """A Mamba sublayer's mixer (plain PyTorch: the reference's is
        jnp, with no Pallas kernel).  Prefill leaves the state after the
        prompt's last token in the cache (h, and the conv rows, zeros
        first for a prompt shorter than them); decode carries it one
        token on, in place."""
        if mode == "decode":
            return M.mamba_decode(h, p, self.cfg, cache)[0]
        if mode != "prefill":
            raise NotImplementedError(
                f"mode {mode!r}: a Mamba sublayer has prefill and decode "
                f"only (no multi-token verify path, as in the reference)")
        o, st = M.mamba_block(h, p, self.cfg, return_state=True)
        cache["h"].copy_(st["h"])
        cache["conv"].copy_(st["conv"])
        return o

    def _reduce(self, x):
        """Complete a row-parallel projection: the sum of every shard's
        partial output over ``tp_group`` (identity without one)."""
        if self.tp_group is None:
            return x
        return C.all_reduce_sum(x, self.tp_group)

    def _apply_rwkv_block(self, x, bp, mode, cache):
        """One RWKV-6 block (reference ``LM._apply_block``, rwkv branch);
        ``cache`` is this layer's dict(S, x_prev_t, x_prev_c), written in
        place.  Prefill runs the scan from a zero state and leaves the
        final state, the last token's ln1 output (``x_prev_t``) and its
        ln2 output (``x_prev_c``); decode carries them one token on."""
        cfg = self.cfg
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        if mode == "prefill":
            o, S = R.time_mix(h, bp["time"], cfg, kernels=self.kernels)
            cache["S"].copy_(S)
            cache["x_prev_t"].copy_(h[:, -1:])
        elif mode == "decode":
            o, _ = R.time_mix_decode(h, bp["time"], cfg,
                                     {"S": cache["S"],
                                      "x_prev": cache["x_prev_t"]})
            cache["x_prev_t"].copy_(h)
        else:
            raise NotImplementedError(
                f"mode {mode!r}: an rwkv stack serves through prefill and "
                f"decode only (training runs through train_loss)")
        x = x + o
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if mode == "prefill":
            o2 = R.channel_mix(h2, bp["chan"])
            cache["x_prev_c"].copy_(h2[:, -1:])
        else:
            o2 = R.channel_mix(h2, bp["chan"], cache["x_prev_c"])
            cache["x_prev_c"].copy_(h2)
        return x + o2

    def _run_stack(self, params, x, mode, cache, pos, pages=None):
        """Run all blocks, stack by stack, repeat by repeat and sublayer
        by sublayer (a hybrid superblock's), over the stacked parameters
        and caches.  One page table serves every layer (the pools are
        stacked per layer, the table is not), so the window's physical
        rows are resolved once here for all of them."""
        if self.grid is not None:
            raise NotImplementedError("a training grid's LM does not serve")
        dest = None
        if pages is not None:
            dest = L.paged_dest(pages, pos, x.shape[1],
                                cache["blocks"]["k"].shape[2])
        for name, subs, n in self.groups:
            for i in range(n):
                for key, kind in subs:
                    p, c = params[name], cache[name]
                    if key is not None:
                        p, c = p[key], c[key]
                    x = self._apply_block(
                        x, tree_map(lambda a: a[i], p), kind, mode,
                        {leaf: t[i] for leaf, t in c.items()}, pos, pages,
                        dest)
        return x

    # ------------------------------------------------------------------
    # Training (the reference's mode == "train")
    # ------------------------------------------------------------------
    def _train_block(self, x, bp, kind, specs=None):
        """One block in train mode: (x, aux), ``aux`` the MoE layer's
        load-balance loss (0 elsewhere).  Attention through the plain
        ``flash_attention_plain`` at ``cfg.attn_chunk`` (the reference's
        ``gqa_attention``), MLA through ``mla_attention``, Mamba and
        RWKV-6 from a zero state with no cache written.  On a grid the
        block's FSDP dims are gathered first (``specs``: the block's
        partition specs), inside the remat unit, so that its recompute
        gathers again as GSPMD's does; each layer whose weights the
        rules split over the model axis then runs its tensor-parallel
        version over the grid's model group (GQA and MLA attention by
        heads, the Mamba mixer by channels, RWKV's time-mix by heads and
        channel-mix by ``d_ff``, the FFNs by ``d_ff``), a layer the rules
        leave whole its plain version, replicated, and every MoE layer
        the expert-parallel one."""
        cfg, grid = self.cfg, self.grid
        if specs is not None:
            from repro_torch.parallel.sharding import gather_fsdp
            bp = gather_fsdp(bp, specs, grid)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        if kind == "rwkv":
            if model_split(specs, "time", "w_r"):
                x = x + R.time_mix_tp(h, bp["time"], cfg, grid)
            else:
                x = x + R.time_mix(h, bp["time"], cfg, kernels=False)[0]
            h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
            if model_split(specs, "chan", "w_k"):
                return x + R.channel_mix_tp(h2, bp["chan"],
                                            grid.model_group), aux
            return x + R.channel_mix(h2, bp["chan"]), aux
        mix, ff = kind.split("_")
        if mix == "attn" and model_split(specs, "attn", "wq"):
            o = L.gqa_attention_tp(h, bp["attn"], cfg, grid)
        elif mix == "attn":
            o = L.gqa_attention(h, bp["attn"], cfg, kernels=False)
        elif mix == "mla" and model_split(specs, "attn", "wq_b"):
            o = L.mla_attention_tp(h, bp["attn"], cfg, grid)
        elif mix == "mla":
            o = L.mla_attention(h, bp["attn"], cfg)
        elif model_split(specs, "mamba", "in_proj"):
            o = M.mamba_block_tp(h, bp["mamba"], cfg, grid)
        else:
            o = M.mamba_block(h, bp["mamba"], cfg)
        x = x + o
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if ff == "moe":
            router = "sigmoid" if cfg.family == "mla_moe" else "softmax"
            if grid is None:
                o2, aux = L.moe_ffn(h2, bp["moe"], cfg, router)
            else:
                o2, aux = L.moe_ffn_ep(h2, bp["moe"], cfg, router, grid)
                if cfg.moe.n_shared:
                    o2 = o2 + self._ffn(h2, bp["moe"]["shared"], model_split(
                        specs, "moe", "shared", "w_gate"))
        else:
            o2 = self._ffn(h2, bp["ffn"],
                           model_split(specs, "ffn", "w_gate"))
        return x + o2, aux

    def _train_stack(self, params, x):
        """All blocks in train mode (the reference's ``_run_stack`` with
        mode "train"): (x, aux).  ``aux`` is the mean over a stack's
        layers, a hybrid's mean over superblocks of (the sum over its
        sublayers, dense ones counted as 0) / period, and for mla_moe
        the MoE stack's mean alone.  A stack's leaves are unbound once,
        so that backward stacks each leaf's gradient in one write."""
        cfg = self.cfg
        aux = None
        for name, subs, n in self.groups:
            unbound = tree_map(lambda a: a.unbind(0), params[name])
            specs = self._block_specs(name)
            if subs[0][0] is None:
                body = L.maybe_remat(functools.partial(
                    self._train_block, kind=subs[0][1], specs=specs),
                    cfg.remat, cfg.remat_policy)
            else:
                body = self._superblock(subs, specs)
            auxes = []
            for i in range(n):
                x, a = body(x, tree_map(lambda t: t[i], unbound))
                auxes.append(a)
            aux = torch.stack(auxes).mean()
        return x, aux

    def _superblock(self, subs, specs=None):
        """A hybrid superblock's train body: its sublayers in order,
        (x, sum of their aux / period); remat wraps the whole superblock,
        or each sublayer under ``sublayer_remat``."""
        remat, sub_remat = self.cfg.remat, self.cfg.sublayer_remat
        policy = self.cfg.remat_policy
        blocks = [(key, L.maybe_remat(functools.partial(
            self._train_block, kind=kind,
            specs=None if specs is None else specs[key]),
            remat and sub_remat, policy))
            for key, kind in subs]

        def body(x, bp):
            aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            for key, fn in blocks:
                x, a = fn(x, bp[key])
                aux_sum = aux_sum + a
            return x, aux_sum / len(blocks)

        return L.maybe_remat(body, remat and not sub_remat, policy)

    def _check_train(self) -> None:
        """Raise on a serving ``tp_group``: sharded training takes a
        ``grid`` (``LM(cfg, grid=...)``)."""
        if self.tp_group is not None:
            raise NotImplementedError(
                "a serving tp_group does not train: sharded training runs "
                "on a grid (LM(cfg, grid=...)), see ROADMAP §A.8")

    def train_forward(self, params, batch):
        """The train path's forward: (logits (B, S, Vp) float32 of the
        tokens' positions, a VLM's patch rows sliced off; the last
        hidden states (B, P + S, D); aux).  On a grid ``batch`` is this
        rank's rows and the logits are its vocabulary block."""
        cfg = self.cfg
        self._check_train()
        x = self._embed_inputs(params, batch)
        x, aux = self._train_stack(params, x)
        logits = self._logits(params, x)
        if cfg.vlm is not None and "patch_embeds" in batch:
            logits = logits[:, batch["patch_embeds"].shape[1]:]
        return logits, x, aux

    def train_loss(self, params, batch):
        """(loss, metrics) of one batch: ``tokens`` and ``labels`` (B, S),
        optional ``loss_mask`` (B, S) weights, a VLM's ``patch_embeds``
        (B, P, E) (their rows are sliced off the logits).  The loss is the
        cross entropy, plus ``AUX_COEF`` x aux for MoE and ``MTP_COEF`` x
        the MTP loss for DeepSeek; metrics ``ce``, ``aux`` (and ``mtp``),
        as in the reference.  On a grid: ``_train_loss_grid``."""
        cfg = self.cfg
        if self.grid is not None:
            return self._train_loss_grid(params, batch)
        logits, x, aux = self.train_forward(params, batch)
        loss = _ce_loss(logits, batch["labels"], cfg.vocab_size, self.vp,
                        batch.get("loss_mask"))
        metrics = {"ce": loss, "aux": aux}
        if cfg.moe is not None:
            loss = loss + AUX_COEF * aux
        if cfg.mtp:
            mtp = self._mtp_loss(params, x, batch)
            metrics["mtp"] = mtp
            loss = loss + MTP_COEF * mtp
        return loss, metrics

    def _train_loss_grid(self, params, batch):
        """Sharded ``train_loss``: ``params`` this rank's blocks, ``batch``
        the global batch, of which the rank takes the rows of its data
        index (``_rank_rows``).  Each term is the rank's share of the
        global one (``_grid_loss``): the cross entropy's sum over the
        rank's tokens over the global token count (or over the global
        ``loss_mask`` weight, at least 1), ``aux`` the data row's (the
        model group's mean of each shard's, as the reference's ``pmean``)
        over the data size, and the MTP loss's share."""
        cfg, grid = self.cfg, self.grid
        local, denom = self._rank_rows(batch)
        logits, x, aux = self.train_forward(params, local)
        ce = self._ce_grid(logits, local["labels"], local.get("loss_mask"),
                           denom)
        terms = {"ce": ce, "aux": aux / grid.data}
        coefs = {"ce": 1.0}
        if cfg.moe is not None:
            coefs["aux"] = AUX_COEF
        if cfg.mtp:
            terms["mtp"] = self._mtp_loss(params, x, local, batch)
            coefs["mtp"] = MTP_COEF
        return self._grid_loss(terms, coefs)

    def _mtp_loss(self, params, h, batch, full=None):
        """DeepSeek-V3's depth-1 multi-token prediction: h_t joined with
        emb(tok_{t+1}) predicts label_{t+1} (= tok_{t+2}); the last two
        positions weigh 0.  On a grid ``batch`` is the rank's rows and
        ``full`` the global batch (its weight is the denominator), and
        the result the rank's share."""
        cfg = self.cfg
        mp, specs = params["mtp"], None
        if self.grid is not None:
            # the block gathers its own leaves and runs tensor-parallel
            # like the stack's blocks
            from repro_torch.parallel.sharding import gather_fsdp
            specs = self.pspecs["mtp"]
            top = [k for k in mp if k != "block"]
            mp = dict(gather_fsdp({k: mp[k] for k in top},
                                  {k: specs[k] for k in top}, self.grid),
                      block=mp["block"])
            specs = specs["block"]
        emb_next = self._embed_rows(params,
                                    torch.roll(batch["tokens"], -1, dims=1))
        z = torch.cat([L.rmsnorm(h, mp["norm_h"], cfg.norm_eps),
                       L.rmsnorm(emb_next, mp["norm_e"], cfg.norm_eps)],
                      dim=-1) @ mp["proj"]
        kind = "mla_dense" if cfg.mla is not None else "attn_dense"
        z = self._train_block(z, mp["block"], kind, specs)[0]
        logits = self._logits(params, z)
        labels = torch.roll(batch["labels"], -1, dims=1)

        def weights(b):
            w = torch.ones(b["labels"].shape, dtype=torch.float32,
                           device=b["labels"].device)
            w[:, -2:] = 0.0
            return w * b["loss_mask"] if "loss_mask" in b else w

        w = weights(batch)
        if self.grid is None:
            return _ce_loss(logits, labels, cfg.vocab_size, self.vp, w)
        return self._ce_grid(logits, labels, w, torch.clamp(
            weights(full).sum(), min=1.0))

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    def _block_cache_specs(self, kind: str, batch: int,
                           max_len: int) -> dict[str, Any]:
        """One layer's cache leaves as (shape, dtype)."""
        cfg = self.cfg
        if kind == "rwkv":
            return R.rwkv_state_defs(cfg, batch, self.dtype)
        if kind.startswith("mamba"):
            return M.mamba_state_defs(cfg, batch, self.dtype)
        if kind.startswith("mla"):
            m = cfg.mla
            return {"c_kv": ((batch, max_len, m.kv_lora_rank), self.dtype),
                    "k_rope": ((batch, max_len, m.qk_rope_head_dim),
                               self.dtype)}
        kv = ((batch, max_len, cfg.n_kv_heads, cfg.head_dim), self.dtype)
        return {"k": kv, "v": kv}

    def cache_specs(self, batch: int, max_len: int,
                    per_slot_pos: bool = False) -> dict[str, Any]:
        """Shapes and dtypes of the cache tree, stacked per layer in each
        stack, plus ``pos`` -- per slot (B,) with ``per_slot_pos``.
        Dense and moe: (L, B, S, KVH, D) K and V.  mla_moe: (L, B, S, R)
        ``c_kv`` and (L, B, S, P) ``k_rope`` in each of its two stacks.
        rwkv: the (L, B, H, dh, dh) float32 state and the (L, B, 1, d)
        token-shift rows, whatever ``max_len``.  hybrid: one dict per
        sublayer ``l{j}_{kind}`` of ``"superblocks"``, leaves stacked
        over the superblocks: K/V, or a Mamba sublayer's (B, Din, N)
        float32 ``h`` and (B, K - 1, Din) ``conv``."""
        def block(kind):
            return self._block_cache_specs(kind, batch, max_len)

        layers = {name: tree_map(lambda s, n=n: ((n,) + s[0], s[1]),
                                 self._sublayers(subs, block))
                  for name, subs, n in self.groups}
        pos_shape = (batch,) if per_slot_pos else ()
        return {"layers": layers, "pos": (pos_shape, torch.int32)}

    def cache_names(self, per_slot_pos: bool = False) -> dict[str, Any]:
        """The logical axis names of every cache leaf (the reference's
        ``cache_pspecs`` path map): K/V (L, B, S, KVH, D) as (None,
        batch, kv_seq, kv_heads, None), MLA latents (None, batch,
        kv_seq, None), the RWKV state (None, batch, rwkv_heads, None,
        None), a Mamba state ``h`` (None, batch, d_inner, None) and its
        ``conv`` rows (None, batch, None, d_inner), any other leaf
        (None, batch, ...), ``pos`` (batch,) per slot or ()."""
        def names(path, spec):
            ndim = len(spec[0])
            if path == "pos":
                return ("batch",)[:ndim]
            leaf = path.rsplit("/", 1)[-1]
            full = {"k": (None, "batch", "kv_seq", "kv_heads", None),
                    "v": (None, "batch", "kv_seq", "kv_heads", None),
                    "c_kv": (None, "batch", "kv_seq", None),
                    "k_rope": (None, "batch", "kv_seq", None),
                    "S": (None, "batch", "rwkv_heads", None, None),
                    "h": (None, "batch", "d_inner", None),
                    "conv": (None, "batch", None, "d_inner")}.get(
                        leaf, (None, "batch") + (None,) * (ndim - 2))
            return full[:ndim]

        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in tree.items()}
            return names(prefix, tree)

        return walk(self.cache_specs(1, 2, per_slot_pos), "")

    def cache_pspecs(self, rules, per_slot_pos: bool = False):
        """Partition specs matching ``cache_specs``' structure (the
        reference's ``LM.cache_pspecs``), from ``cache_names``."""
        from repro_torch.parallel.sharding import logical_pspec
        return tree_map(lambda n: logical_pspec(n, rules),
                        self.cache_names(per_slot_pos))

    def init_cache(self, batch: int, max_len: int,
                   per_slot_pos: bool = False):
        return tree_map(
            lambda s: torch.zeros(s[0], dtype=s[1], device=self.device),
            self.cache_specs(batch, max_len, per_slot_pos))

    def paged_cache_specs(self, batch: int, n_pages: int, page_size: int,
                          pages_per_slot: int) -> dict[str, Any]:
        """Shapes and dtypes of the paged engine's cache tree: stacked
        (L, P, page_size, KVH, D) K and V page pools shared by all
        slots, a per-slot (B,) ``pos`` and the (B, NB) int32 page
        table.  GQA stacks of the dense and moe families only, as the
        reference's ``paged_cache_specs`` takes: a vlm's is refused too."""
        self.check_verify()
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"paged KV needs a homogeneous attention stack of the dense "
                f"or moe family, as in the reference; family "
                f"{cfg.family!r} is refused")
        pool = ((cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim), self.dtype)
        return {"layers": {"blocks": {"k": pool, "v": pool}},
                "pos": ((batch,), torch.int32),
                "pages": ((batch, pages_per_slot), torch.int32)}

    def init_paged_cache(self, batch: int, n_pages: int, page_size: int,
                         pages_per_slot: int):
        return tree_map(
            lambda s: torch.zeros(s[0], dtype=s[1], device=self.device),
            self.paged_cache_specs(batch, n_pages, page_size,
                                   pages_per_slot))

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def _embed_inputs(self, params, inputs):
        """Token embeddings, behind a VLM's projected ``patch_embeds``
        where the inputs have them (the reference's prefix: ``patch_embeds
        .astype(x.dtype) @ patch_proj``, then the tokens)."""
        x = self._embed_rows(params, inputs["tokens"])
        if self.cfg.vlm is not None and "patch_embeds" in inputs:
            pe = inputs["patch_embeds"].to(x.dtype) @ self._fsdp(
                params, "patch_proj")
            x = torch.cat([pe, x], dim=1)
        return x

    # ------------------------------------------------------------------
    # Prefill / decode entry points
    # ------------------------------------------------------------------
    def prefill(self, params, inputs, max_len: Optional[int] = None, *,
                cache: Optional[dict] = None):
        """inputs["tokens"]: (B, S) -> last-token logits (B, 1, Vp) and
        the cache, K/V at rows [0, S) and zeros up to ``max_len``.  A VLM's
        ``inputs["patch_embeds"]`` (B, P, E) go first: the sequence is then
        P + S rows long, and so is the returned ``pos``.

        ``cache`` (a tree shaped like ``cache_specs(B, max_len)["layers"]``,
        e.g. views of one slot of an engine's cache) is written in place
        instead of allocating a fresh one.  An rwkv prefill writes each
        layer's final state and token-shift rows there, an MLA prefill
        its latent rows, a Mamba sublayer its final state."""
        x = self._embed_inputs(params, inputs)
        b, seq = x.shape[0], x.shape[1]
        max_len = max_len or seq
        if seq > max_len:
            raise ValueError(f"prompt of {seq} rows (patches and tokens) > "
                             f"max_len {max_len}")
        if cache is None:
            cache = self.init_cache(b, max_len)["layers"]
        x = self._run_stack(params, x, "prefill", cache, None)
        logits = self._logits(params, x[:, -1:])
        return logits, {"layers": cache,
                        "pos": torch.tensor(seq, dtype=torch.int32,
                                            device=x.device)}

    def verify_step(self, params, cache, tokens):
        """tokens: (B, T) -> logits (B, T, Vp) and the cache, the T
        tokens' K/V written in place at per-slot rows ``[pos, pos + T)``
        (through the page table when the cache has one).  ``pos`` is
        returned unchanged: the caller advances it (by the accepted
        length, in speculative decoding), which rolls rejected tokens
        back in place -- their rows sit past the new frontier and the
        next window overwrites them.  GQA stacks (dense and moe) only."""
        self.check_verify()
        pos = cache["pos"]
        pages = cache.get("pages")
        x = self._embed_inputs(params, {"tokens": tokens})
        x = self._run_stack(params, x, "verify", cache["layers"], pos,
                            pages)
        logits = self._logits(params, x)
        out = {"layers": cache["layers"], "pos": pos}
        if pages is not None:
            out["pages"] = pages
        return logits, out

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> logits (B, 1, Vp) and the cache, its K/V
        written in place and ``pos`` advanced by one.

        ``cache["pos"]`` may be a scalar (fixed batch) or a per-slot (B,)
        tensor (continuous batching); a ``cache["pages"]`` table sends
        the step through the paged KV pool and stays in the tree."""
        pos = cache["pos"]
        pages = cache.get("pages")
        x = self._embed_inputs(params, {"tokens": tokens})
        x = self._run_stack(params, x, "decode", cache["layers"], pos, pages)
        logits = self._logits(params, x)
        out = {"layers": cache["layers"], "pos": pos + 1}
        if pages is not None:
            out["pages"] = pages
        return logits, out
