"""AdamW with optional int8 moments and the warmup-cosine schedule
(PyTorch port of the reference ``optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, OptState, adamw_init, adamw_update, clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
