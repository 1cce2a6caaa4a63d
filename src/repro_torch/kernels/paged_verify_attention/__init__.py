from repro_torch.kernels.paged_verify_attention.ops import (  # noqa: F401
    paged_verify_attention, paged_verify_attention_plain,
    verify_attention_plain,
)
