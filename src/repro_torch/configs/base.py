"""Model / run configuration system (PyTorch port).

A copy of the JAX package's ``configs/base.py``, field for field, so a
config built here compares equal to the reference one.  Knobs that only
the JAX path reads (``remat``, ``scan_layers``, ``use_pallas``, ...)
are kept for that parity and ignored by the port, which switches to its
CUDA kernels by the device of its tensors (see ``repro_torch.models.lm``).
``repro_torch.configs.get_config(name)`` is the registry entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts
    first_k_dense: int = 0        # leading dense layers (DeepSeek style)
    capacity_factor: float = 1.25
    moe_every: int = 1            # MoE layer every N layers (Jamba: 2)
    d_ff_dense: Optional[int] = None  # FFN dim of the dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2/V3 Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Interleave pattern (Jamba): attention every `attn_period` layers."""

    attn_period: int = 8
    attn_offset: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 12
    enc_len: int = 1500           # whisper: 30 s audio -> 1500 frames
    # conv frontend is a STUB: input_specs() supplies frame embeddings.


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 576          # stubbed CLIP patch embeddings
    patch_embed_dim: Optional[int] = None  # defaults to d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | mla_moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    mtp: bool = False             # DeepSeek multi-token prediction module
    # --- runtime knobs -------------------------------------------------
    dtype: str = "bfloat16"       # activation/param compute dtype
    remat: bool = True
    scan_layers: bool = True
    unroll_scans: bool = False    # calibration mode: no lax.scan anywhere
                                  # (XLA cost_analysis counts loop bodies
                                  # once; see launch/roofline.py)
    # --- perf-iteration knobs (EXPERIMENTS.md §Perf) -------------------
    causal_skip: bool = False     # triangular attention: only visit KV
                                  # blocks <= q block (pallas kernel
                                  # parity; jnp path in unroll mode)
    attn_bf16_scores: bool = False  # bf16 score tensors, f32 row stats
    cache_dus: bool = False       # decode cache update via
                                  # dynamic_update_slice (vs one-hot)
    prefill_fsdp: bool = False    # ZeRO-3 weight gathering at prefill
    attn_chunk: int = 1024        # flash q-chunk size (jnp path)
    remat_policy: str = "nothing"  # "nothing" | "dots" (save matmul outs)
    sublayer_remat: bool = False  # hybrid: checkpoint each of the 8
                                  # sublayers instead of the superblock
                                  # (jamba: ~4x lower temp memory)
    use_pallas: bool = False      # flip on real TPU; CPU uses jnp refs
    pallas_interpret: bool = False  # run the Pallas kernels in interpret
                                  # mode (CPU correctness/parity tests)
    quant: Optional[str] = None   # None | "int8" | "fp8" weight/act quant
    seq_shard_kv: bool = True     # sequence-shard KV cache for decode
    subquadratic: bool = False    # eligible for long_500k

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    # ------------------------------------------------------------------
    # Analytic parameter count (embedding + blocks + head), used by the
    # power model and for the MODEL_FLOPS = 6*N*D roofline sanity term.
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_dim
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            p = d * (n_q * dh) + 2 * d * (n_kv * dh) + (n_q * dh) * d
            if self.qkv_bias:
                p += n_q * dh + 2 * n_kv * dh
            return p

        def dense_ffn(d_ff: int) -> int:
            return 3 * d * d_ff  # SwiGLU: gate, up, down

        def mamba_params() -> int:
            mc = self.mamba
            d_in = mc.expand * d
            dt_rank = mc.dt_rank or -(-d // 16)
            p = d * 2 * d_in                       # in_proj (x and z)
            p += d_in * mc.d_conv                  # depthwise conv
            p += d_in * (dt_rank + 2 * mc.d_state)  # x -> dt, B, C
            p += dt_rank * d_in + d_in             # dt proj + bias
            p += d_in * mc.d_state + d_in          # A_log, D
            p += d_in * d                          # out_proj
            return p

        def rwkv_params() -> int:
            # RWKV-6 block: time-mix (r,k,v,g,o + data-dep decay lora) + channel-mix
            p = 5 * d * d                          # r,k,v,g,output
            p += 2 * (d * 64 + 64 * d)             # decay + token-shift loras (approx)
            p += d * self.d_ff + self.d_ff * d + d * d  # channel mix (k, v, r)
            return p

        total = emb
        per_layer_norms = 2 * d
        for layer in range(self.n_layers):
            total += per_layer_norms
            if self.family == "rwkv":
                total += rwkv_params()
                continue
            is_attn = True
            if self.family == "hybrid":
                is_attn = (layer % self.hybrid.attn_period) == self.hybrid.attn_offset
            total += attn_params() if is_attn else mamba_params()
            # FFN / MoE
            if self.moe is not None:
                mo = self.moe
                if layer < mo.first_k_dense or (layer % mo.moe_every) != 0:
                    total += dense_ffn(mo.d_ff_dense or self.d_ff)
                else:
                    n_routed = mo.top_k if active_only else mo.n_experts
                    total += (n_routed + mo.n_shared) * dense_ffn(mo.d_expert)
                    total += d * mo.n_experts      # router
            else:
                total += dense_ffn(self.d_ff)
        if self.family == "encdec":
            # encoder blocks + cross attention in decoder
            e = self.encdec
            total += e.enc_layers * (attn_params() + dense_ffn(self.d_ff) + 2 * d)
            total += self.n_layers * attn_params()  # cross-attn per dec layer
        if self.mtp:
            total += attn_params() + dense_ffn(
                self.moe.d_expert * (self.moe.top_k + self.moe.n_shared)
                if self.moe else self.d_ff) + 2 * d
        return int(total)

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (see DESIGN.md §4)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
