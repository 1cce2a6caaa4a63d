"""Learning-rate schedules (PyTorch port of the reference
``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``.  ``step`` is a 0-d int
    tensor; the result is a 0-d float32 tensor on its device (no host
    read)."""
    s = step.float()
    warm = peak_lr * s / max(1, warmup)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
