"""PyTorch + CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

The package mirrors the JAX package's layout (``configs``, ``models``,
``kernels``, ``serving``, ``launch``) and imports nothing from it: what
it needs it carries as its own copy.  Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU the
default raises instead of quietly running on the CPU.

float32 products stay full float32 on the card, as on the CPU: TF32 is
switched off for matmuls and cuDNN alike.  bf16 products keep running
on the tensor cores in bf16.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no
    GPU is visible (there is no silent fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev
