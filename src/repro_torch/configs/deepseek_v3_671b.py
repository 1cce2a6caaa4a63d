"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

[arXiv:2412.19437]; first 3 layers dense (d_ff 18432), experts d_ff 2048.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,           # MLA: all heads read the shared latent cache
    d_head=128,
    d_ff=18432,               # dense-layer FFN dim
    vocab_size=129280,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  first_k_dense=3, d_ff_dense=18432),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    mtp=True,
)
