"""Tensor parallelism of the port on ``torch.distributed``: the dense
LM's Megatron layout (``sharding``) and one process per shard
(``launch.run_tp``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    TP_AXES, shard_params, tp_all_reduce, tp_dim, tp_local_config,
)
from repro_torch.parallel.launch import run_tp  # noqa: F401
