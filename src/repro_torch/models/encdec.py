"""Encoder-decoder model, the whisper-small backbone (PyTorch port).

The counterpart of the reference ``models/encdec.py::EncDecLM``: the
same parameter tree (``embed``, ``lm_head``, ``enc_blocks``,
``enc_norm``, ``dec_blocks`` with ``ln_x``/``xattn``, ``final_norm``),
the same cache tree (``self_k``, ``self_v``, ``cross_k``, ``cross_v``
and a scalar ``pos``) and the same ``prefill`` / ``decode_step`` API.

The conv/mel frontend is a stub, as in the reference: the caller
supplies precomputed frame embeddings (B, enc_len, d_model) as
``inputs["frames"]``.  The encoder is a bidirectional transformer; the
decoder adds causal self-attention over a KV cache and cross-attention
to the encoder's K/V, computed once at prefill.  Positions are
sinusoidal (the reference's documented simplification of whisper's
learned ones), and the decoder's self-attention also applies RoPE,
because the reference's does.  Every attention of the stack goes
through the flash kernel (encoder and cross-attention bidirectional,
decoder prefill causal) except the decoder's one-token self-attention,
which goes through the decode kernel.  Layers run as a Python loop;
the self-attention cache is updated in place where the reference's
jitted callers donate it.  ``train_loss`` runs every attention on the
plain path (the kernels have no backward).

  m = EncDecLM(cfg, device="cuda")
  params = m.init(seed=0)                  # or param.from_jax(tree)
  logits, cache = m.prefill(params, {"frames": f, "tokens": t}, 448)
  logits, cache = m.decode_step(params, cache, next_tokens)

``EncDecLM(cfg, grid=grid)`` trains sharded on a ``parallel.grid.Grid``
with the LM's grid API (``rules``, ``pspecs``, ``shard``, ``gather``:
``models.lm.GridTraining``), under the reference's ``make_rules(cfg,
mesh, "train")`` layout: FSDP over the data axis; over the model axis,
the encoder's bidirectional attention without RoPE, the decoder's causal
self-attention and its cross-attention by heads, the FFNs by ``d_ff``
(a dimension the rules leave whole is replicated), and a
vocab-parallel embedding, head and cross entropy.  The cross K/V are
projected from the encoder output, which enters the rank's heads through
``copy_to``; where the rules leave the KV heads whole, each rank takes
those its query heads attend (``layers.kv_window``).  A grid's model
trains only.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.models import layers as L
from repro_torch.models.lm import GridTraining, _ce_loss, model_split
from repro_torch.models.param import (DTYPES, ParamDef, init_params,
                                      stack_tree, tree_map)


def sinusoid(s: int, d: int, dtype, device=None) -> torch.Tensor:
    """(s, d) sinusoidal position table, computed in float32 and cast
    once to ``dtype``, as the reference does."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def cross_attention(x, ctx_k, ctx_v, p, cfg, *, kernels: bool = True):
    """x: (B, Sq, d) attends, bidirectionally, to the encoder's K/V
    ``ctx_k``/``ctx_v`` (B, enc_len, KVH, D)."""
    b, sq, _ = x.shape
    q = (x @ p["wq"]).reshape(b, sq, cfg.n_heads, cfg.head_dim)
    if kernels:
        o = flash_attention(q, ctx_k, ctx_v, causal=False)
    else:
        o = flash_attention_plain(q, ctx_k, ctx_v, causal=False)
    return o.reshape(b, sq, -1) @ p["wo"]


def cross_attention_tp(x, ctx_k, ctx_v, p, cfg, grid):
    """``cross_attention`` on this rank's query heads over the model
    group of ``grid``: x (B, Sq, d) replicated over the group enters
    through ``copy_to``, ``ctx_k``/``ctx_v`` are the rank's KV heads,
    and the output is summed over the group."""
    from repro_torch.parallel.collectives import copy_to, reduce_from
    b, sq, _ = x.shape
    q = (copy_to(x, grid.model_group) @ p["wq"]).reshape(b, sq, -1,
                                                         cfg.head_dim)
    o = flash_attention_plain(q, ctx_k, ctx_v, causal=False)
    return reduce_from(o.reshape(b, sq, -1) @ p["wo"], grid.model_group)


def cross_kv(ctx, p, cfg):
    """The encoder output's K and V for one decoder layer, each
    (B, enc_len, KVH, D) (on a grid, the rank's KV heads)."""
    b, s, _ = ctx.shape
    dh = cfg.head_dim
    return ((ctx @ p["wk"]).reshape(b, s, -1, dh),
            (ctx @ p["wv"]).reshape(b, s, -1, dh))


class EncDecLM(GridTraining):
    """Whisper-style encoder-decoder.  ``device`` defaults to ``cuda``
    and raises when no GPU is visible.  ``kernels=False`` sends every
    attention to the plain PyTorch versions on any device (the on-card
    yardstick); with ``kernels=True`` CUDA tensors go through the
    hand-written kernels and CPU tensors through the same plain
    versions.  ``grid``: sharded training on a ``parallel.grid.Grid``
    (``train_loss`` only; see the module docstring)."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kernels: bool = True, grid=None):
        if cfg.family != "encdec" or cfg.encdec is None:
            raise ValueError(f"EncDecLM needs an encdec config, got family "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.vp = L.pad_vocab(cfg.vocab_size)
        self.device = resolve_device(device)
        self.kernels = kernels
        self.dtype = DTYPES[cfg.dtype]
        self._tables: dict[int, torch.Tensor] = {}
        self.grid = grid
        if grid is not None:
            self._init_grid(grid)

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def _enc_block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln1": L.rmsnorm_def(cfg.d_model, cfg.dtype),
                "attn": L.gqa_defs(cfg),
                "ln2": L.rmsnorm_def(cfg.d_model, cfg.dtype),
                "ffn": L.ffn_defs(cfg)}

    def _dec_block_defs(self) -> dict:
        d = self._enc_block_defs()
        d["ln_x"] = L.rmsnorm_def(self.cfg.d_model, self.cfg.dtype)
        d["xattn"] = L.gqa_defs(self.cfg, cross=True)
        return d

    def param_defs(self):
        cfg = self.cfg
        return {
            "embed": ParamDef((self.vp, cfg.d_model), ("vocab", "fsdp"),
                              "embed", cfg.dtype),
            "lm_head": ParamDef((cfg.d_model, self.vp), ("fsdp", "vocab"),
                                "normal", cfg.dtype),
            "enc_blocks": stack_tree(self._enc_block_defs(),
                                     cfg.encdec.enc_layers),
            "enc_norm": L.rmsnorm_def(cfg.d_model, cfg.dtype),
            "dec_blocks": stack_tree(self._dec_block_defs(), cfg.n_layers),
            "final_norm": L.rmsnorm_def(cfg.d_model, cfg.dtype),
        }

    def init(self, seed: int = 0):
        """Seeded random weights, drawn on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen)

    def train_loss(self, params, batch):
        """(loss, metrics) of one batch: ``frames`` (B, enc_len,
        d_model), decoder ``tokens`` and ``labels`` (B, S), optional
        ``loss_mask``.  The reference's ``train_loss``: the encoder, every
        layer's cross K/V, the decoder stack in train mode (causal
        self-attention from position 0, cross-attention, FFN), cross
        entropy over the padded vocabulary; metrics ``ce`` and ``aux``
        (0).  Every attention runs the plain version whatever
        ``kernels`` says (the kernels have no backward), self-attention
        with ``cfg.causal_skip`` and ``cfg.attn_bf16_scores``; remat by
        ``cfg.remat`` wraps each encoder and decoder layer, keeping only
        its inputs (the reference's encdec takes no ``remat_policy``).
        On a grid ``batch`` is the global batch, of which the rank takes
        the rows of its data index, and the loss is its share
        (``models.lm.GridTraining``)."""
        cfg, grid = self.cfg, self.grid
        if grid is not None:
            batch, denom = self._rank_rows(batch)
        enc_out = self.encode(params, batch["frames"], train=True)
        # unbound once, so that backward stacks each layer's gradient
        # once (indexing the stack would write a whole stack a layer)
        cross_k, cross_v = (t.unbind(0) for t in
                            self._cross_kv_all(params, enc_out))
        x = self._embed_dec(params, batch["tokens"])
        body = L.maybe_remat(self._train_dec_block, cfg.remat)
        # the cross K/V projections were used above
        layers = tree_map(lambda a: a.unbind(0), dict(
            params["dec_blocks"], xattn={
                k: v for k, v in params["dec_blocks"]["xattn"].items()
                if k not in ("wk", "wv")}))
        for i in range(cfg.n_layers):
            x = body(x, tree_map(lambda t: t[i], layers), cross_k[i],
                     cross_v[i])
        logits = self._logits(params, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if grid is not None:
            ce = self._ce_grid(logits, batch["labels"],
                               batch.get("loss_mask"), denom)
            return self._grid_loss({"ce": ce, "aux": aux}, {"ce": 1.0})
        loss = _ce_loss(logits, batch["labels"], cfg.vocab_size, self.vp,
                        batch.get("loss_mask"))
        return loss, {"ce": loss, "aux": aux}

    def _dec_specs(self):
        """One decoder layer's partition specs without the cross K/V
        projections (``_cross_kv_all`` gathers those); ``None`` off a
        grid."""
        specs = self._block_specs("dec_blocks")
        if specs is not None:
            specs = dict(specs, xattn={k: v for k, v in
                                       specs["xattn"].items()
                                       if k not in ("wk", "wv")})
        return specs

    def _train_dec_block(self, x, bp, ck, cv):
        """One decoder layer in train mode, on the plain path; on a grid
        its FSDP dims gathered first and each split layer run
        tensor-parallel (``bp`` and its specs hold no cross K/V
        projection: ``_cross_kv_all`` ran them)."""
        cfg, grid = self.cfg, self.grid
        specs = self._dec_specs()
        if specs is not None:
            from repro_torch.parallel.sharding import gather_fsdp
            bp = gather_fsdp(bp, specs, grid)
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        if model_split(specs, "attn", "wq"):
            x = x + L.gqa_attention_tp(h, bp["attn"], cfg, grid)
        else:
            x = x + L.gqa_attention(h, bp["attn"], cfg, kernels=False)
        h = L.rmsnorm(x, bp["ln_x"], cfg.norm_eps)
        if model_split(specs, "xattn", "wq"):
            x = x + cross_attention_tp(h, ck, cv, bp["xattn"], cfg, grid)
        else:
            x = x + cross_attention(h, ck, cv, bp["xattn"], cfg,
                                    kernels=False)
        h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + self._ffn(h, bp["ffn"], model_split(specs, "ffn",
                                                       "w_gate"))

    # ------------------------------------------------------------------
    # Encoder, cross K/V, decoder stack
    # ------------------------------------------------------------------
    def _table(self, s: int) -> torch.Tensor:
        """``sinusoid(s, d_model)`` in the model's dtype, built once per
        length on the model's device."""
        if s not in self._tables:
            self._tables[s] = sinusoid(s, self.cfg.d_model, self.dtype,
                                       self.device)
        return self._tables[s]

    def encode(self, params, frames, *, train: bool = False):
        """frames: (B, enc_len, d_model), the stubbed frontend's output
        -> the normed encoder output, same shape, in the model's dtype.
        ``train``: the plain attention path and remat by ``cfg.remat``,
        as ``train_loss`` needs."""
        cfg, grid = self.cfg, self.grid
        kernels = self.kernels and not train
        specs = self._block_specs("enc_blocks")

        def block(x, bp):
            if specs is not None:
                from repro_torch.parallel.sharding import gather_fsdp
                bp = gather_fsdp(bp, specs, grid)
            h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
            if model_split(specs, "attn", "wq"):
                x = x + L.gqa_attention_tp(h, bp["attn"], cfg, grid,
                                           causal=False, use_rope=False)
            else:
                x = x + L.gqa_attention(h, bp["attn"], cfg, causal=False,
                                        use_rope=False, kernels=kernels)
            h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
            return x + self._ffn(h, bp["ffn"], model_split(specs, "ffn",
                                                           "w_gate"))

        if train:
            block = L.maybe_remat(block, cfg.remat)
        x = frames.to(self.dtype)
        x = x + self._table(x.shape[1])[None]
        layers = tree_map(lambda a: a.unbind(0), params["enc_blocks"])
        for i in range(cfg.encdec.enc_layers):
            x = block(x, tree_map(lambda t: t[i], layers))
        return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)

    def _cross_kv_all(self, params, enc_out):
        """Every decoder layer's cross K and V, computed once at prefill:
        (k, v), each (L, B, enc_len, KVH, D).  The stacked weights are
        unbound once (under autograd, indexing the stack a layer at a
        time would write a whole stack's gradient a layer).  On a grid
        each layer's ``wk``/``wv`` have their FSDP dims gathered, and
        where the cross-attention is split over the model axis
        ``enc_out`` enters through ``copy_to`` and the rank projects the
        KV heads its query heads attend: its block of them, or, where
        the rules leave them whole, its ``kv_window`` of the whole
        projections (which then enter through ``copy_to`` too)."""
        cfg, grid = self.cfg, self.grid
        ks, vs = [], []
        xattn = tree_map(lambda a: a.unbind(0), {
            k: params["dec_blocks"]["xattn"][k] for k in ("wk", "wv")})
        specs = self._block_specs("dec_blocks")
        split = model_split(specs, "xattn", "wq")
        if split:
            from repro_torch.parallel.collectives import copy_to
            enc_out = copy_to(enc_out, grid.model_group)
        for i in range(cfg.n_layers):
            p = tree_map(lambda a: a[i], xattn)
            if specs is not None:
                from repro_torch.parallel.sharding import gather_fsdp
                p = gather_fsdp(p, {k: specs["xattn"][k] for k in p}, grid)
            if split and L.kv_replicated(p["wk"], cfg, grid.model):
                dh = cfg.head_dim
                lo, hi = L.kv_window(grid.index("model"),
                                     cfg.n_heads // grid.model,
                                     cfg.n_heads // cfg.n_kv_heads)
                p = {k: copy_to(w, grid.model_group)[:, lo * dh:hi * dh]
                     for k, w in p.items()}
            k, v = cross_kv(enc_out, p, cfg)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs)

    def _embed_dec(self, params, tokens, pos0: int = 0):
        x = self._embed_rows(params, tokens)
        return x + self._table(pos0 + tokens.shape[1])[pos0:][None]

    def _dec_stack(self, params, x, mode: str, cache, pos):
        """Run the decoder blocks.  ``mode`` "prefill" writes each
        layer's K/V at rows [0, S) of the (zeroed) self-attention cache;
        "decode" writes one row at ``pos`` and attends up to it.  Both
        cross-attend to the cache's ``cross_k``/``cross_v``."""
        cfg = self.cfg
        if self.grid is not None:
            raise NotImplementedError("a training grid's EncDecLM does not "
                                      "serve")
        for i in range(cfg.n_layers):
            bp = tree_map(lambda a: a[i], params["dec_blocks"])
            kv = {"k": cache["self_k"][i], "v": cache["self_v"][i]}
            h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
            if mode == "prefill":
                o, (k, v) = L.gqa_prefill(h, bp["attn"], cfg,
                                          kernels=self.kernels)
                kv["k"][:, :k.shape[1]] = k
                kv["v"][:, :v.shape[1]] = v
            else:
                o = L.gqa_decode(h, bp["attn"], cfg, kv, pos,
                                 kernels=self.kernels)
            x = x + o
            h = L.rmsnorm(x, bp["ln_x"], cfg.norm_eps)
            x = x + cross_attention(h, cache["cross_k"][i],
                                    cache["cross_v"][i], bp["xattn"], cfg,
                                    kernels=self.kernels)
            h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
            x = x + L.ffn(h, bp["ffn"])
        return x

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int) -> dict[str, Any]:
        """Shapes and dtypes of the cache tree: (L, B, max_len, KVH, D)
        self-attention K/V, (L, B, enc_len, KVH, D) cross K/V and a
        scalar ``pos``."""
        cfg = self.cfg

        def kv(s):
            return ((cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim),
                    self.dtype)

        e = cfg.encdec.enc_len
        return {"self_k": kv(max_len), "self_v": kv(max_len),
                "cross_k": kv(e), "cross_v": kv(e),
                "pos": ((), torch.int32)}

    def cache_names(self) -> dict[str, Any]:
        """The logical axis names of every cache leaf: self K/V (None,
        batch, kv_seq, kv_heads, None), cross K/V (None, batch, None,
        kv_heads, None), ``pos`` ()."""
        kvs = (None, "batch", "kv_seq", "kv_heads", None)
        kvx = (None, "batch", None, "kv_heads", None)
        return {"self_k": kvs, "self_v": kvs, "cross_k": kvx,
                "cross_v": kvx, "pos": ()}

    def cache_pspecs(self, rules):
        """Partition specs matching ``cache_specs`` (the reference's
        ``EncDecLM.cache_pspecs``)."""
        from repro_torch.parallel.sharding import logical_pspec
        return tree_map(lambda n: logical_pspec(n, rules),
                        self.cache_names())

    def init_cache(self, batch: int, max_len: int):
        return tree_map(
            lambda s: torch.zeros(s[0], dtype=s[1], device=self.device),
            self.cache_specs(batch, max_len))

    # ------------------------------------------------------------------
    # Prefill / decode entry points
    # ------------------------------------------------------------------
    def prefill(self, params, inputs, max_len: Optional[int] = None):
        """inputs: ``frames`` (B, enc_len, d_model) and ``tokens`` (B, S),
        the decoder prompt -> last-token logits (B, 1, Vp) over the
        padded vocabulary and the cache: self K/V at rows [0, S) and
        zeros up to ``max_len``, the encoder's cross K/V, ``pos`` = S."""
        if "frames" not in inputs:
            raise ValueError(
                "EncDecLM.prefill needs inputs['frames'] (B, enc_len, "
                "d_model), the stubbed audio frontend's output; pass it "
                "as ServeEngine.run_batch(..., extra_inputs={'frames': "
                "...})")
        tokens = inputs["tokens"]
        b, s = tokens.shape
        max_len = max_len or s
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens > max_len {max_len}")
        enc_out = self.encode(params, inputs["frames"])
        cross_k, cross_v = self._cross_kv_all(params, enc_out)
        specs = self.cache_specs(b, max_len)
        cache = {n: torch.zeros(specs[n][0], dtype=specs[n][1],
                                device=self.device)
                 for n in ("self_k", "self_v")}
        cache.update(cross_k=cross_k, cross_v=cross_v,
                     pos=torch.tensor(s, dtype=torch.int32,
                                      device=self.device))
        x = self._dec_stack(params, self._embed_dec(params, tokens),
                            "prefill", cache, None)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> logits (B, 1, Vp) and the cache, the new
        self K/V row written in place at ``pos`` and ``pos`` advanced by
        one.  The position row is picked on the device: no host read."""
        pos = cache["pos"]
        pe = torch.index_select(self._table(cache["self_k"].shape[2]), 0,
                                pos.reshape(1).long())
        x = params["embed"][tokens] + pe[None]
        x = self._dec_stack(params, x, "decode", cache, pos)
        return self._logits(params, x), dict(cache, pos=pos + 1)
