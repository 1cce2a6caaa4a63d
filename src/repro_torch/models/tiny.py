"""MLPerf-Tiny-scale keyword-spotting model (DS-CNN class), PyTorch port.

The counterpart of the reference ``src/repro/models/tiny.py``: the same
parameter tree, the same float32 forward (a stem projection, per layer
a 3-tap depthwise conv over time and a pointwise matmul with bias and
ReLU, mean pooling, a class head) and the same analytic MAC and SRAM
counts for the MCU energy model.

  model = TinyModel(cfg, device="cuda")
  params = model.init(seed=0)              # or param.from_jax(tree)
  logits = model(params, x)                # x: (B, 49, 10) MFCC

On the card the float32 matmuls must run in full float32: the port
switches TF32 off at import (``repro_torch/__init__.py``), and the
forward refuses to run on a CUDA tensor if something switched it back
on, rather than quietly changing the setting.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDef, init_params

# MFCC input: 49 frames x 10 coefficients (speech-commands standard)
IN_T, IN_F = 49, 10


def param_defs(cfg):
    d, classes = cfg.d_model, cfg.vocab_size
    defs = {"stem": ParamDef((IN_F, d), (None, None), "normal", "float32")}
    for i in range(cfg.n_layers):
        defs[f"dw{i}"] = ParamDef((3, d), (None, None), "normal", "float32")
        defs[f"pw{i}"] = ParamDef((d, d), (None, None), "normal", "float32")
        defs[f"b{i}"] = ParamDef((d,), (None,), "zeros", "float32")
    defs["head"] = ParamDef((d, classes), (None, None), "normal", "float32")
    return defs


def check_no_tf32(x: torch.Tensor) -> None:
    """Raise if a float32 matmul on ``x``'s device would run in TF32."""
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "tiny forward: torch.backends.cuda.matmul.allow_tf32 is on; "
            "the model is held against the reference in full float32")


def depthwise_conv(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3-tap depthwise conv over time with one zero row each side:
    ``sum_j hp[:, j:j + T] * w[j]``, summed in the reference's order."""
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1))
    t = h.shape[1]
    return sum(hp[:, j:j + t] * w[j] for j in range(3))


def forward(params, x, cfg):
    """x: (B, 49, 10) MFCC -> (B, classes) logits, float32."""
    check_no_tf32(x)
    h = x @ params["stem"]                                # (B, T, d)
    for i in range(cfg.n_layers):
        conv = depthwise_conv(h, params[f"dw{i}"])
        h = torch.relu(conv @ params[f"pw{i}"] + params[f"b{i}"])
    pooled = h.mean(dim=1)
    return pooled @ params["head"]


def macs(cfg) -> int:
    d = cfg.d_model
    m = IN_T * IN_F * d                        # stem
    m += cfg.n_layers * (IN_T * 3 * d + IN_T * d * d)
    m += d * cfg.vocab_size
    return int(m)


def sram_bytes(cfg) -> int:
    """Weights + one activation plane, int8-quantized deployment."""
    w = IN_F * cfg.d_model + cfg.n_layers * (3 * cfg.d_model
                                             + cfg.d_model ** 2 + cfg.d_model)
    w += cfg.d_model * cfg.vocab_size
    act = 2 * IN_T * cfg.d_model
    return int(w + act)


class TinyModel:
    """The tiny keyword spotter.  ``device`` defaults to ``cuda`` and
    raises when no GPU is visible."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "tiny":
            raise ValueError(f"TinyModel: family {cfg.family!r} is not tiny")
        self.cfg = cfg
        self.device = resolve_device(device)

    def param_defs(self):
        return param_defs(self.cfg)

    def init(self, seed: int = 0):
        """Seeded random weights, drawn on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen)

    def __call__(self, params, x):
        return forward(params, x, self.cfg)

    def train_loss(self, params, batch):
        raise NotImplementedError(
            "TinyModel.train_loss: training is not ported yet, see "
            "ROADMAP §A.12")

    @property
    def macs(self) -> int:
        return macs(self.cfg)

    @property
    def sram_bytes(self) -> int:
        return sram_bytes(self.cfg)
