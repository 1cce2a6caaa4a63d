"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (STUB).

[hf:microsoft/Phi-3-vision-128k-instruct].  The CLIP vision tower is a
stub per the assignment: ``input_specs()`` supplies precomputed patch
embeddings; the backbone consumes them as a prefix.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    vlm=VLMConfig(n_patches=576),
)
