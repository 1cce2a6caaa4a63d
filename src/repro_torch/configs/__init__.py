"""Config registry: ``get_config("qwen3-1.7b")`` and reduced smoke configs.

Every architecture of the JAX package: the dense decoders, the MoE and
MLA-MoE decoders (qwen3-moe, deepseek-v3), the Mamba + attention hybrid
(jamba), rwkv6, the whisper encoder-decoder, the VLMs (phi-3-vision,
edge-vit) and the tiny keyword spotter.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (  # noqa: F401
    EncDecConfig, HybridConfig, MLAConfig, MambaConfig, MoEConfig,
    ModelConfig, ShapeConfig, SHAPES, VLMConfig, shape_applicable,
)

_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "tiny-kws": "tiny_kws",
    "whisper-small": "whisper_small",
    "yi-9b": "yi_9b",
    "edge-vit": "edge_vit",
}


# The ten assigned LM architectures (tiny/edge are paper-own extras),
# in the reference's order: the dry-run's cells and the paper-figure
# benchmarks walk them.
ASSIGNED_ARCHS = [
    "granite-3-2b", "qwen2.5-3b", "qwen3-1.7b", "yi-9b",
    "qwen3-moe-30b-a3b", "deepseek-v3-671b", "phi-3-vision-4.2b",
    "jamba-v0.1-52b", "rwkv6-3b", "whisper-small",
]


def list_archs() -> list[str]:
    """The architectures the port can build."""
    return list(_ARCH_MODULES)


def get_config(name: str, **overrides) -> ModelConfig:
    key = name.replace("_", "-") if name not in _ARCH_MODULES else name
    for arch, mod in _ARCH_MODULES.items():
        if name == mod:
            key = arch
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[key]}")
    cfg = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test scale, preserving the family.

    The reference ``reduce_config``'s cut: at most 4 layers, width 128,
    4/2 heads of 32, vocab 512, float32; rwkv keeps 4/4 heads of 32; MoE
    keeps at most 8 experts, top-2, of width 128 and at most 1 leading
    dense layer (of width 256 where the config has one); MLA takes ranks
    64/32 and head dims 32 + 16 / 32; hybrid keeps 8 layers (one Jamba
    period); encdec keeps 2 encoder layers over 64 frames and 2 decoder
    layers; a VLM keeps 16 patches.  A tiny config is returned unchanged
    (it is already tiny).
    """
    if cfg.family == "tiny":
        return cfg
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_head=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        remat=False,
    )
    if cfg.family == "rwkv":
        changes.update(n_heads=4, n_kv_heads=4, d_head=32)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=128,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            d_ff_dense=256 if cfg.moe.d_ff_dense else None,
        )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                   qk_nope_head_dim=32, qk_rope_head_dim=16,
                                   v_head_dim=32)
    if cfg.hybrid is not None:
        changes.update(n_layers=8)  # one full Jamba period
    if cfg.encdec is not None:
        changes["encdec"] = dataclasses.replace(cfg.encdec, enc_layers=2,
                                                enc_len=64)
        changes["n_layers"] = 2
    if cfg.vlm is not None:
        changes["vlm"] = dataclasses.replace(cfg.vlm, n_patches=16)
    return dataclasses.replace(cfg, **changes)
