from repro_torch.kernels.paged_decode_attention.ops import (  # noqa: F401
    paged_decode_attention, paged_decode_attention_plain, paged_view,
)
