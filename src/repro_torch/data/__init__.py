"""The deterministic synthetic data pipeline (PyTorch port of the
reference ``data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticTokens, batch_for_shape, pack_documents,
)
