"""edge-vit — edge-scale vision transformer (paper-own workload).

Edge-category single-SoC inference workload (Samples/Joule metric with a
virtual SPEC analyzer).  ViT-S/16-class backbone on 224x224 inputs,
patch embeddings stubbed like the other modality frontends.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="edge-vit",
    family="vlm",
    n_layers=12,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=1000,          # classifier head
    vlm=VLMConfig(n_patches=196),
    scan_layers=True,
)
