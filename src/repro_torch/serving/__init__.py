"""Serving engines of the port: contiguous and paged KV, radix prefix
caching, speculative decoding, chunked prefill, the deadline-slack
scheduler with preemption, prefill/decode disaggregation
(``PrefillWorker`` -> ``KVHandoff`` -> ``DisaggregatedEngine``), and
tensor-parallel serving over ``torch.distributed``
(``ShardedContinuousBatchingEngine``, one process per shard)."""
from repro_torch.serving.disagg import (  # noqa: F401
    DisaggregatedEngine, KVHandoff, PrefillWorker,
)
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousBatchingEngine, Request, ServeEngine,
    attribute_request_energy,
)
from repro_torch.serving.kv_pages import (  # noqa: F401
    GARBAGE_PAGE, PagePool, PoolExhausted,
)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serving.scheduler import Scheduler  # noqa: F401
from repro_torch.serving.sharded import (  # noqa: F401
    ShardedContinuousBatchingEngine, replicate_kv_heads,
)
from repro_torch.serving.speculative import (  # noqa: F401
    damp_upper_layers, greedy_verify, speculative_sample, truncate_draft,
)
