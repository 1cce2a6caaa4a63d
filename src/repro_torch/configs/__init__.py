"""Config registry: ``get_config("qwen3-1.7b")`` and reduced smoke configs.

Only the dense decoder families are ported so far; asking for any other
architecture the JAX package knows raises ``NotImplementedError``.
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
    "yi-9b": "yi_9b",
}

# architectures of the reference package whose families (MoE, MLA,
# hybrid, RWKV, enc-dec, VLM, tiny) the port does not run yet
_NOT_PORTED = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-small": "whisper_small",
    "tiny-kws": "tiny_kws",
    "edge-vit": "edge_vit",
}


def list_archs() -> list[str]:
    """The architectures the port can build."""
    return list(_ARCH_MODULES)


def get_config(name: str, **overrides) -> ModelConfig:
    key = name.replace("_", "-") if name not in _ARCH_MODULES else name
    for table in (_ARCH_MODULES, _NOT_PORTED):
        for arch, mod in table.items():
            if name == mod:
                key = arch
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {key!r} is not ported yet, see ROADMAP §A.11 "
            f"(the port runs the dense family: {list_archs()})")
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

    The same cut as the reference ``reduce_config`` for dense models:
    at most 4 layers, width 128, 4/2 heads of 32, vocab 512, float32.
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet, see ROADMAP §A.11")
    return dataclasses.replace(
        cfg,
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
