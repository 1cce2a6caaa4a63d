"""Model zoo entry point: ``build_model(cfg)`` (dense, rwkv and tiny
families)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda", *, kernels: bool = True):
    if cfg.family == "tiny":
        from repro_torch.models.tiny import TinyModel
        return TinyModel(cfg, device)
    from repro_torch.models.lm import LM
    return LM(cfg, device, kernels=kernels)
