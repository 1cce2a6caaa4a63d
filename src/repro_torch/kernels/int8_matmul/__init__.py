from repro_torch.kernels.int8_matmul.ops import (  # noqa: F401
    int8_matmul, int8_matmul_plain, quantize_int8,
)
