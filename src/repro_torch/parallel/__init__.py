"""Parallelism of the port on ``torch.distributed``: the dense LM's
Megatron serving layout and the training rules' slicing
(``sharding``), one process per shard (``launch.run_tp``,
``run_grid``), sharded training's grid of ranks (``grid``) and its
collectives with gradients (``collectives``), and the GPipe schedule
(``pipeline``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    TP_AXES, shard_params, tp_dim, tp_local_config,
)
from repro_torch.parallel.launch import run_grid, run_tp  # noqa: F401
from repro_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction, pipeline_forward, split_microbatches,
)
