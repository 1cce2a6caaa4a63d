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
    def _apply_block(self, x, bp, mode, cache, pos):
        """One ``attn_dense`` block; ``cache`` (this layer's dict(k, v))
        is written in place.  Returns the block output."""
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
        elif mode == "decode":
            o = L.gqa_decode(h, bp["attn"], cfg, cache, pos,
                             kernels=self.kernels)
        else:
            raise NotImplementedError(
                f"mode {mode!r}: training and speculative verify are not "
                f"ported yet, see ROADMAP §A.7 and §A.12")
        x = x + o
        h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + L.ffn(h2, bp["ffn"])

    def _run_stack(self, params, x, mode, cache, pos):
        """Run all blocks over the stacked parameters and caches."""
        for i in range(self.cfg.n_layers):
            bp = tree_map(lambda a: a[i], params["blocks"])
            c = {"k": cache["blocks"]["k"][i], "v": cache["blocks"]["v"][i]}
            x = self._apply_block(x, bp, mode, c, pos)
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

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> logits (B, 1, Vp) and the cache, its K/V
        written in place and ``pos`` advanced by one.

        ``cache["pos"]`` may be a scalar (fixed batch) or a per-slot (B,)
        tensor (continuous batching)."""
        pos = cache["pos"]
        x = self._embed_inputs(params, {"tokens": tokens})
        x = self._run_stack(params, x, "decode", cache["layers"], pos)
        logits = self._logits(params, x)
        return logits, {"layers": cache["layers"], "pos": pos + 1}

