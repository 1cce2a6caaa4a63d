"""Config registry: ``get_config("qwen3-1.7b")`` and reduced smoke configs.

The dense decoder family, rwkv6 and the tiny keyword spotter are
ported so far; asking for any other architecture the JAX package knows
raises ``NotImplementedError``.
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
    "rwkv6-3b": "rwkv6_3b",
    "tiny-kws": "tiny_kws",
    "yi-9b": "yi_9b",
}

# architectures of the reference package whose families (MoE, MLA,
# hybrid, enc-dec, VLM) the port does not run yet
_NOT_PORTED = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-small": "whisper_small",
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
            f"(the port runs the dense, rwkv and tiny families: "
            f"{list_archs()})")
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

    The same cut as the reference ``reduce_config`` for the ported
    families: at most 4 layers, width 128, 4/2 heads of 32, vocab 512,
    float32; rwkv keeps 4/4 heads of 32.  A tiny config is returned
    unchanged (it is already tiny).
    """
    if cfg.family == "tiny":
        return cfg
    if cfg.family not in ("dense", "rwkv"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet, see ROADMAP §A.11")
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
    return dataclasses.replace(cfg, **changes)
