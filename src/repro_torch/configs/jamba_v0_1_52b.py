"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]: 32 layers = 4 Jamba blocks of 8; attention at layer
index 4 of each block; MoE every other layer.
"""
from repro_torch.configs.base import (HybridConfig, MambaConfig, MoEConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, moe_every=2,
                  d_ff_dense=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    hybrid=HybridConfig(attn_period=8, attn_offset=4),
    subquadratic=True,
)
