"""tiny-kws — MLPerf-Tiny-scale keyword spotting (paper-own workload).

A DS-CNN-class keyword spotter [arXiv:1711.07128] used by the tiny-scale
power methodology (energy-per-inference, 1/J metric).  Not one of the
assigned LM architectures; this is the paper's own µW-regime workload,
modeled as a small MLP-conv hybrid over MFCC features.

Copied field for field from the reference ``src/repro/configs/tiny_kws.py``.
"""
from repro_torch.configs.base import ModelConfig

# We reuse ModelConfig fields loosely: d_model = feature dim, n_layers =
# conv/fc blocks.  The tiny model is built by repro_torch.models.tiny.
CONFIG = ModelConfig(
    name="tiny-kws",
    family="tiny",
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=12,            # 12 keyword classes
    dtype="float32",
    remat=False,
    scan_layers=False,
)
