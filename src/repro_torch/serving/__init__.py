"""Serving engines of the port (contiguous greedy path)."""
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousBatchingEngine, Request, ServeEngine,
    attribute_request_energy,
)
