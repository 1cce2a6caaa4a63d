"""Decoder-only language model, dense family (PyTorch port).

The counterpart of the reference ``models/lm.py::LM`` for
``family == "dense"``: the same parameter tree (one ``"blocks"`` stack
with a leading layer axis), the same cache tree, and the same
``prefill`` / ``decode_step`` API.  Layers run as a Python loop over
the stack.  Caches are updated in place where the reference's jitted
callers donate them.

  lm = LM(cfg, device="cuda")
  params = lm.init(seed=0)                 # or param.from_jax(tree)
  logits, cache = lm.prefill(params, {"tokens": toks}, max_len=2048)
  logits, cache = lm.decode_step(params, cache, next_tokens)

The paged engine's cache tree (``init_paged_cache``) holds page pools
shared by all slots plus a ``pages`` table; ``decode_step`` and
``verify_step`` then go through the page table.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import (DTYPES, ParamDef, init_params,
                                      stack_tree, tree_map)



class LM:
    """Dense GQA decoder.  ``device`` defaults to ``cuda`` and raises
    when no GPU is visible.  ``kernels=False`` sends attention to the
    plain PyTorch versions on any device (the on-card yardstick); with
    ``kernels=True`` CUDA tensors go through the hand-written kernels
    and CPU tensors through the same plain versions."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 kernels: bool = True):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only the dense family "
                f"(attn_dense blocks) is ported; see ROADMAP §A.11")
        self.cfg = cfg
        self.vp = L.pad_vocab(cfg.vocab_size)
        self.device = resolve_device(device)
        self.kernels = kernels
        self.dtype = DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def _block_defs(self) -> dict:
        """One ``attn_dense`` block, the only layer kind ported."""
        cfg = self.cfg
        return {"ln1": L.rmsnorm_def(cfg.d_model, cfg.dtype),
                "ln2": L.rmsnorm_def(cfg.d_model, cfg.dtype),
                "attn": L.gqa_defs(cfg),
                "ffn": L.ffn_defs(cfg)}

    def param_defs(self):
        cfg = self.cfg
        dt = cfg.dtype
        return {
            "embed": ParamDef((self.vp, cfg.d_model), ("vocab", "fsdp"),
                              "embed", dt),
            "final_norm": L.rmsnorm_def(cfg.d_model, dt),
            # randomly initialised over the padded columns too, as in the
            # reference: greedy argmax runs over all of them
            "lm_head": ParamDef((cfg.d_model, self.vp), ("fsdp", "vocab"),
                                "normal", dt),
            "blocks": stack_tree(self._block_defs(), cfg.n_layers),
        }

    def init(self, seed: int = 0):
        """Seeded random weights, drawn on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen)

    # ------------------------------------------------------------------
    # Block application
    # ------------------------------------------------------------------
    def _apply_block(self, x, bp, mode, cache, pos, pages=None, dest=None):
        """One ``attn_dense`` block; ``cache`` (this layer's dict(k, v))
        is written in place.  ``pages`` (B, NB) switches decode and
        verify to the paged KV pool: the cache leaves are then shared
        physical pages, not per-slot rows (``dest``: the window's
        ``paged_dest``).  Returns the block output."""
        cfg = self.cfg
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        if mode == "prefill":
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
        elif mode == "verify" and pages is not None:
            o = L.gqa_verify_paged(h, bp["attn"], cfg, cache, pos, pages,
                                   kernels=self.kernels, dest=dest)
        else:
            raise NotImplementedError(
                f"mode {mode!r} without a page table: training and the "
                f"contiguous speculative verify are not ported yet, see "
                f"ROADMAP §A.7 and §A.12")
        x = x + o
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + L.ffn(h2, bp["ffn"])

    def _run_stack(self, params, x, mode, cache, pos, pages=None):
        """Run all blocks over the stacked parameters and caches.  One
        page table serves every layer (the pools are stacked per layer,
        the table is not), so the window's physical rows are resolved
        once here for all of them."""
        dest = None
        if pages is not None:
            dest = L.paged_dest(pages, pos, x.shape[1],
                                cache["blocks"]["k"].shape[2])
        for i in range(self.cfg.n_layers):
            bp = tree_map(lambda a: a[i], params["blocks"])
            c = {"k": cache["blocks"]["k"][i], "v": cache["blocks"]["v"][i]}
            x = self._apply_block(x, bp, mode, c, pos, pages, dest)
        return x

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int,
                    per_slot_pos: bool = False) -> dict[str, Any]:
        """Shapes and dtypes of the cache tree: stacked (L, B, S, KVH, D)
        K and V, plus ``pos`` -- per slot (B,) with ``per_slot_pos``."""
        cfg = self.cfg
        kv = ((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
              self.dtype)
        pos_shape = (batch,) if per_slot_pos else ()
        return {"layers": {"blocks": {"k": kv, "v": kv}},
                "pos": (pos_shape, torch.int32)}

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
        table."""
        cfg = self.cfg
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
        return params["embed"][inputs["tokens"]]

    def _logits(self, params, x):
        x = L.rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return (x @ params["lm_head"]).float()

    # ------------------------------------------------------------------
    # Prefill / decode entry points
    # ------------------------------------------------------------------
    def prefill(self, params, inputs, max_len: Optional[int] = None, *,
                cache: Optional[dict] = None):
        """inputs["tokens"]: (B, S) -> last-token logits (B, 1, Vp) and
        the cache, K/V at rows [0, S) and zeros up to ``max_len``.

        ``cache`` (a ``{"blocks": {"k", "v"}}`` tree of (L, B, max_len,
        KVH, D) tensors, e.g. views of one slot of an engine's cache) is
        written in place instead of allocating a fresh one."""
        x = self._embed_inputs(params, inputs)
        b, seq = x.shape[0], x.shape[1]
        max_len = max_len or seq
        if seq > max_len:
            raise ValueError(f"prompt of {seq} tokens > max_len {max_len}")
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
        through the page table.  ``pos`` is returned unchanged: the
        caller advances it (by the accepted length, in speculative
        decoding).  Only the paged form is ported; the contiguous
        verify waits for speculative decoding (ROADMAP §A.7)."""
        pos = cache["pos"]
        pages = cache.get("pages")
        if pages is None:
            raise NotImplementedError(
                "verify_step without a page table (contiguous "
                "speculative verify) is not ported yet, see ROADMAP §A.7")
        x = self._embed_inputs(params, {"tokens": tokens})
        x = self._run_stack(params, x, "verify", cache["layers"], pos,
                            pages)
        logits = self._logits(params, x)
        return logits, {"layers": cache["layers"], "pos": pos,
                        "pages": pages}

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
