"""Serving engines of the port (contiguous and paged greedy paths)."""
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousBatchingEngine, Request, ServeEngine,
    attribute_request_energy,
)
from repro_torch.serving.kv_pages import (  # noqa: F401
    GARBAGE_PAGE, PagePool, PoolExhausted,
)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
