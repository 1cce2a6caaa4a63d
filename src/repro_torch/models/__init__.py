"""Model zoo entry point: ``build_model(cfg)`` (dense family only)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda", *, kernels: bool = True):
    from repro_torch.models.lm import LM
    return LM(cfg, device, kernels=kernels)
