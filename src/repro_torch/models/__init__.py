"""Model zoo entry point: ``build_model(cfg)`` (dense, rwkv, encdec and
tiny families)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda", *, kernels: bool = True):
    if cfg.family == "tiny":
        from repro_torch.models.tiny import TinyModel
        return TinyModel(cfg, device)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, device, kernels=kernels)
    from repro_torch.models.lm import LM
    return LM(cfg, device, kernels=kernels)
