"""Model zoo entry point: ``build_model(cfg)`` (every family: the
decoder-only ones through ``lm.LM``, encdec and tiny through their own
models)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda", *, kernels: bool = True,
                grid=None):
    """``grid``: a ``parallel.grid.Grid`` for sharded training (the
    decoder-only LM and the encoder-decoder; the reference gives the
    tiny model no sharding annotation)."""
    if grid is not None and cfg.family == "tiny":
        raise NotImplementedError(f"family {cfg.family!r}: sharded "
                                  f"training takes the LM and the "
                                  f"encoder-decoder")
    if cfg.family == "tiny":
        from repro_torch.models.tiny import TinyModel
        return TinyModel(cfg, device)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, device, kernels=kernels, grid=grid)
    from repro_torch.models.lm import LM
    return LM(cfg, device, kernels=kernels, grid=grid)
