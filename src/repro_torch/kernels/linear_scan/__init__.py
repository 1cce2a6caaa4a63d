from repro_torch.kernels.linear_scan.ops import (  # noqa: F401
    linear_scan, linear_scan_plain,
)
