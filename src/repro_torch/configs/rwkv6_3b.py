"""rwkv6-3b [ssm] — Finch, data-dependent decay; attention-free.

[arXiv:2404.05892].  Decode state is O(H * d_head^2) independent of
context length: runs long_500k natively.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,               # head_size 64
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab_size=65536,
    subquadratic=True,
)
