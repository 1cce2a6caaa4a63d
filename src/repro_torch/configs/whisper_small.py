"""whisper-small [audio] — enc-dec, conv frontend (STUB).

[arXiv:2212.04356].  12L encoder + 12L decoder, d=768.  The conv1d/mel
frontend is a stub: the caller supplies precomputed frame embeddings
(batch, 1500, d_model) as ``inputs["frames"]``.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,              # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    encdec=EncDecConfig(enc_layers=12, enc_len=1500),
)
