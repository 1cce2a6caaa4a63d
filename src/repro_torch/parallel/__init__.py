"""Parallelism of the port on ``torch.distributed``: the dense LM's
Megatron layout (``sharding``), one process per shard
(``launch.run_tp``) and the GPipe schedule (``pipeline``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    TP_AXES, shard_params, tp_all_reduce, tp_dim, tp_local_config,
)
from repro_torch.parallel.launch import run_tp  # noqa: F401
from repro_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction, pipeline_forward, split_microbatches,
)
