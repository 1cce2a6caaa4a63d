from repro_torch.kernels.verify_attention.ops import (  # noqa: F401
    verify_attention, verify_attention_plain,
)
